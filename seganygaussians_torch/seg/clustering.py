"""Clustering of affinity features: spherical k-means instead of HDBSCAN.

Counterpart of ``seganygaussians_tpu/seg/clustering.py``:

* ``kmeans``         — Lloyd iterations (cosine or Euclidean) from k-means++
                       centers.
* ``density_filter`` — the lowest-similarity quantile of the points labelled
                       noise (-1), as HDBSCAN's noise label.
* ``cluster_features`` — the GUI's recipe: subsample, cluster, return the
                       normalised cluster centers.

The JAX package draws with ``jax.random``; its numbers cannot be repeated
here, so every draw goes through a ``torch.Generator`` and each function also
takes what it would draw (initial centers, subsample indices), which is how
the tests hold it to the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seganygaussians_torch.seg.queries import normalize
from seganygaussians_torch.utils.precision import ieee_fp32_matmul


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (K, D)
    labels: torch.Tensor  # (N,) int32; -1 = noise after density_filter
    similarity: torch.Tensor  # (N,) assignment score (cos sim or -dist²)


def _similarity(x: torch.Tensor, centers: torch.Tensor, cosine: bool) -> torch.Tensor:
    """(N, K) cosine similarity, or negative squared distance."""
    if cosine:
        with ieee_fp32_matmul():
            return x @ centers.T
    return -torch.sum((x[:, None, :] - centers[None, :, :]) ** 2, dim=-1)


def kmeanspp_init(generator: torch.Generator, x: torch.Tensor, k: int,
                  cosine: bool = True) -> torch.Tensor:
    """(K, D) k-means++ centers: the first uniformly, each next one with
    probability proportional to its distance (1 − cos, or squared distance)
    to the nearest center so far."""
    n = x.shape[0]
    dev = generator.device
    first = torch.randint(n, (1,), generator=generator, device=dev).to(x.device)
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first[0]]
    for i in range(1, k):
        best = torch.amax(_similarity(x, centers[:i], cosine), dim=1)
        d2 = torch.clamp_min(1.0 - best if cosine else -best, 1e-9)
        nxt = torch.multinomial((d2 / d2.sum()).to(dev), 1, generator=generator)
        centers[i] = x[nxt.to(x.device)[0]]
    return centers


def kmeans(
    x: torch.Tensor,  # (N, D)
    k: int,
    iters: int = 20,
    cosine: bool = True,
    generator: Optional[torch.Generator] = None,
    init_centers: Optional[torch.Tensor] = None,
) -> KMeansResult:
    """Lloyd's k-means from ``init_centers`` or k-means++ centers drawn with
    ``generator``.  ``cosine=True`` normalises the inputs and the centers each
    round (spherical k-means), the metric of SAGA's L2-normalised affinity
    features; ``init_centers`` then lie among the normalised inputs."""
    if cosine:
        x = normalize(x)
    if init_centers is None:
        if generator is None:
            raise ValueError("kmeans needs a generator or init_centers")
        init_centers = kmeanspp_init(generator, x, k, cosine)
    centers = init_centers.to(device=x.device, dtype=x.dtype)
    for _ in range(iters):
        labels = torch.argmax(_similarity(x, centers, cosine), dim=1)
        sums = torch.zeros_like(centers).index_add_(0, labels, x)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)[:, None]
        new = torch.where(counts > 0, sums / counts.clamp_min(1), centers)
        centers = normalize(new) if cosine else new
    sim = _similarity(x, centers, cosine)
    labels = torch.argmax(sim, dim=1)  # the first of equal maxima, as jnp.argmax
    return KMeansResult(centers=centers, labels=labels.to(torch.int32),
                        similarity=torch.amax(sim, dim=1))


def density_filter(result: KMeansResult, noise_quantile: float = 0.1) -> KMeansResult:
    """Mark the lowest-similarity ``noise_quantile`` of the points as noise
    (-1).  ``torch.quantile`` takes at most 2^24 elements: run it on the
    clustered subsample, as ``cluster_features`` clusters one."""
    thresh = torch.quantile(result.similarity, noise_quantile)
    labels = torch.where(result.similarity < thresh, -1, result.labels)
    return result._replace(labels=labels.to(torch.int32))


def cluster_features(
    features: torch.Tensor,  # (N, D) scale-gated affinity features
    k: int = 32,
    sample_rate: float = 0.02,
    iters: int = 20,
    generator: Optional[torch.Generator] = None,
    indices: Optional[torch.Tensor] = None,
    init_centers: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The GUI's clustering recipe: spherical k-means on a subsample of
    ``max(k, N · sample_rate)`` points (``indices``, or drawn without
    replacement with ``generator``); returns the (K, D) normalised centers,
    against which ``einsum('nc,bc->bn', centers, features)`` scores."""
    n = features.shape[0]
    if indices is None:
        if generator is None:
            raise ValueError("cluster_features needs a generator or indices")
        m = max(k, int(n * sample_rate))
        indices = torch.randperm(n, generator=generator, device=generator.device)[:m]
    res = kmeans(features[indices.to(features.device)], k, iters=iters, cosine=True,
                 generator=generator, init_centers=init_centers)
    return res.centers
