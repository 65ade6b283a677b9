"""Browser-based interactive segmentation GUI (the reference's ``saga_gui.py``).

Counterpart of ``seganygaussians_tpu/viewer/web_gui.py``, standard library
``http.server`` and PIL only: one HTML page (canvas and controls) and JSON
and PNG endpoints that drive a headless :class:`~.interactive.SagaSession`.
Each widget of the reference GUI is an endpoint:

| saga_gui widget           | endpoint                                  |
|---------------------------|-------------------------------------------|
| orbit drag / scroll zoom  | the ``az``, ``el``, ``r`` of GET /render  |
| render-mode checkboxes    | GET /render?mode= (rgb, pca, similarity, cluster) |
| scale and threshold       | POST /state (GET /state reads them)       |
| left-click prompt         | POST /click                               |
| segment3d button          | POST /segment                             |
| roll back / clear         | POST /undo, POST /clear                   |
| save mask                 | POST /save                                |
| cluster in 3D             | POST /cluster                             |

The server is single-threaded (``HTTPServer``), so renders on the device
never run concurrently.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>SAGA viewer (PyTorch)</title><style>
body{font-family:sans-serif;background:#181818;color:#ddd;margin:0;display:flex}
#panel{width:260px;padding:12px}#panel div{margin:8px 0}
canvas{cursor:crosshair}button{margin:2px}
label{display:inline-block;width:90px}
</style></head><body>
<div><canvas id=c width=800 height=600></canvas></div>
<div id=panel>
 <div><label>mode</label>
  <select id=mode><option>rgb</option><option>pca</option>
  <option>similarity</option><option>cluster</option></select></div>
 <div><label>scale</label><input id=scale type=range min=0 max=1 step=0.01 value=0.5>
  <span id=scaleval>0.50</span></div>
 <div><label>threshold</label><input id=thr type=range min=0 max=1 step=0.01 value=0.75>
  <span id=thrval>0.75</span></div>
 <div><button id=segment>segment 3D</button><button id=undo>roll back</button></div>
 <div><button id=clear>clear prompts</button><button id=save>save mask</button></div>
 <div><button id=cluster>cluster in 3D</button></div>
 <div id=status>ready</div>
</div>
<script>
const c=document.getElementById('c'),ctx=c.getContext('2d');
let az=0,el=0,r=4,drag=null;
function refresh(){
 const m=document.getElementById('mode').value;
 const img=new Image();
 img.onload=()=>ctx.drawImage(img,0,0);
 img.src=`/render?mode=${m}&az=${az}&el=${el}&r=${r}&t=${Date.now()}`;
}
async function post(p,b){const res=await fetch(p,{method:'POST',body:JSON.stringify(b||{})});
 const j=await res.json();document.getElementById('status').textContent=j.status||'ok';
 refresh();return j;}
c.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey]};
c.onmousemove=e=>{if(!drag)return;
 az+=(e.clientX-drag[0])*0.01;el+=(e.clientY-drag[1])*0.01;
 drag=[e.clientX,e.clientY,drag[2]];refresh();}
c.onmouseup=e=>{if(drag&&Math.abs(e.clientX-drag[0])<3){
 const rect=c.getBoundingClientRect();
 post('/click',{x:Math.round(e.clientX-rect.left),y:Math.round(e.clientY-rect.top),
  az:az,el:el,r:r});}
 drag=null;}
c.onwheel=e=>{e.preventDefault();r*=e.deltaY>0?1.1:0.9;refresh();}
document.getElementById('mode').onchange=refresh;
document.getElementById('scale').oninput=e=>{
 document.getElementById('scaleval').textContent=(+e.target.value).toFixed(2);
 post('/state',{scale:+e.target.value});};
document.getElementById('thr').oninput=e=>{
 document.getElementById('thrval').textContent=(+e.target.value).toFixed(2);
 post('/state',{threshold:+e.target.value});};
for(const id of ['segment','undo','clear','save','cluster'])
 document.getElementById(id).onclick=()=>post('/'+id);
refresh();
</script></body></html>"""


class WebGUI:
    """Serve a SagaSession over HTTP.  ``session`` provides render_rgb,
    render_pca, render_similarity, render_cluster, click, segment3d,
    roll_back, clear_clicks, save_mask, cluster_in_3d, ``orbit``, ``scale``,
    ``threshold`` and ``chosen_features``."""

    def __init__(self, session, host: str = "127.0.0.1", port: int = 8060):
        self.session = session
        self.host = host
        self.port = port
        self._httpd = None

    def _render_png(self, mode: str) -> bytes:
        from PIL import Image

        s = self.session
        fn = {
            "rgb": s.render_rgb,
            "pca": s.render_pca,
            "similarity": lambda: _colorize(s.render_similarity()),
            "cluster": s.render_cluster,
        }[mode]
        img = np.asarray(fn())
        if img.ndim == 2:
            img = _colorize(img)
        buf = io.BytesIO()
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(buf, "PNG")
        return buf.getvalue()

    def make_handler(self):
        gui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, body: bytes, content_type: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(json.dumps(obj).encode(), "application/json", code)

            def do_GET(self):
                u = urlparse(self.path)
                s = gui.session
                if u.path == "/":
                    self._send(_PAGE.encode(), "text/html")
                elif u.path == "/render":
                    q = parse_qs(u.query)
                    s.orbit.azimuth = float(q.get("az", [0])[0])
                    s.orbit.elevation = float(q.get("el", [0])[0])
                    s.orbit.radius = float(q.get("r", [4])[0])
                    self._send(gui._render_png(q.get("mode", ["rgb"])[0]), "image/png")
                elif u.path == "/state":
                    self._json({"scale": s.scale, "threshold": s.threshold,
                                "prompts": len(s.chosen_features)})
                else:
                    self._json({"status": "not found"}, 404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                payload = json.loads(self.rfile.read(length) or b"{}")
                s = gui.session
                path = urlparse(self.path).path
                try:
                    if path == "/click":
                        s.orbit.azimuth = float(payload.get("az", s.orbit.azimuth))
                        s.orbit.elevation = float(payload.get("el", s.orbit.elevation))
                        s.orbit.radius = float(payload.get("r", s.orbit.radius))
                        s.click(int(payload["x"]), int(payload["y"]))
                        self._json({"status": f"{len(s.chosen_features)} prompts"})
                    elif path == "/state":
                        if "scale" in payload:
                            s.scale = float(payload["scale"])
                        if "threshold" in payload:
                            s.threshold = float(payload["threshold"])
                        self._json({"status": "state updated"})
                    elif path == "/segment":
                        mask = s.segment3d()
                        self._json({"status": f"segmented {int(np.asarray(mask).sum())} gaussians"})
                    elif path == "/undo":
                        s.roll_back()
                        self._json({"status": "rolled back"})
                    elif path == "/clear":
                        s.clear_clicks()
                        self._json({"status": "prompts cleared"})
                    elif path == "/save":
                        self._json({"status": f"saved {s.save_mask()}"})
                    elif path == "/cluster":
                        s.cluster_in_3d()
                        self._json({"status": "clustered"})
                    else:
                        self._json({"status": "not found"}, 404)
                except Exception as e:  # the server keeps running; the page shows it
                    self._json({"status": f"error: {e}"}, 500)

        return Handler

    def serve_forever(self):
        self._httpd = HTTPServer((self.host, self.port), self.make_handler())
        print(f"SAGA viewer at http://{self.host}:{self._httpd.server_address[1]}", flush=True)
        try:
            self._httpd.serve_forever()
        finally:
            self._httpd.server_close()

    def start_background(self):
        """Serve from a daemon thread; returns the bound (host, port)."""
        self._httpd = HTTPServer((self.host, self.port), self.make_handler())
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self._httpd.server_address

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()


def _colorize(score: np.ndarray) -> np.ndarray:
    """Score map → heat colors (the similarity overlay)."""
    s = np.clip(np.asarray(score), 0.0, 1.0)
    return np.stack([s, 0.2 + 0.3 * s, 1.0 - s], axis=-1)
