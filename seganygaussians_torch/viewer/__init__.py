"""Viewers: the interactive segmentation session, the browser GUI and the
SIBR network protocol."""
