"""The viewer: an HTTP frame server over the orbit renderer (counterpart of
``pagnerf_tpu/app/viewer_server.py``).

Any browser switches channels, cycles the dataset's views, orbits a free
camera, clicks a pixel for its embedding distance and trains while it
views. Frames render on the trainer's device through
``orbit_renderer`` and are served as PNGs that
``utils/visualization.png_bytes`` encodes (no PIL). One lock keeps every
trainer call apart: a render and a training epoch, which runs in a second
thread, never launch work on the card at the same time. Frames are cached
per view (the free camera's poses in an LRU of ``MAX_FREE_POSES``) until
an epoch ends.

    python -m pagnerf_tpu_torch.cli --config <yaml> [--pretrained <ckpt>] \
        --viewer [--viewer-port 8080]

Endpoints
    GET  /                     viewer page (canvas, channel buttons, view cycling)
    GET  /api/info             views, channels, epoch, running flag, last losses
    GET  /api/frame?view=I&channel=C   rendered channel as PNG
    GET  /api/free_frame?az=A&el=E&r=R&channel=C   a pose on the orbit as PNG
    GET  /api/click?view=I&y=Y&x=X     embedding-distance-to-clicked-pixel PNG
    POST /api/train?epochs=N   run N training epochs in a background thread
    POST /api/stop             request the training thread to stop after its epoch
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils.visualization import png_bytes
from .orbit_renderer import (embedding_distance_image, pose_from_orbit,
                             render_channels_for_pose, render_channels_for_view)

CHANNELS = ("rgb", "depth", "semantics", "instance")

_PAGE = """<!doctype html><html><head><title>pagnerf_tpu_torch viewer</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:1em}
button{margin:2px;padding:4px 10px;background:#333;color:#ddd;border:1px solid #555}
button.on{background:#265}#frame{image-rendering:pixelated;max-width:90vw;border:1px solid #444}
</style></head><body>
<div id=bar></div>
<div><button onclick="mv(-1)">&lt; prev view</button><span id=vi></span>
<button onclick="mv(1)">next view &gt;</button>
<button id=fc onclick="togglefree()">free cam</button>
<button onclick="train()">train 1 epoch</button><span id=st></span></div>
<div id=freebar style="display:none">
<button onclick="orb(-15,0,0)">&#8592;</button><button onclick="orb(15,0,0)">&#8594;</button>
<button onclick="orb(0,10,0)">&#8593;</button><button onclick="orb(0,-10,0)">&#8595;</button>
<button onclick="orb(0,0,-0.25)">zoom+</button><button onclick="orb(0,0,0.25)">zoom-</button>
<span id=cam></span> <span>(or arrow keys / +/-)</span></div>
<img id=frame onclick="clk(event)">
<script>
let info={views:[],channels:[]},v=0,ch='rgb',free=false,az=0,el=20,rad=2.2;
async function load(){info=await (await fetch('api/info')).json();
 const bar=document.getElementById('bar');bar.innerHTML='';
 for(const c of info.channels){const b=document.createElement('button');
  b.textContent=c;b.id='ch_'+c;b.onclick=()=>{ch=c;refresh()};bar.appendChild(b)}
 refresh()}
function refresh(){document.getElementById('vi').textContent=' view '+info.views[v]+' ';
 for(const c of info.channels)document.getElementById('ch_'+c).className=c==ch?'on':'';
 document.getElementById('st').textContent=' epoch '+info.epoch+(info.training?' [training]':'');
 document.getElementById('fc').className=free?'on':'';
 document.getElementById('freebar').style.display=free?'':'none';
 document.getElementById('cam').textContent=' az '+az+' el '+el+' r '+rad.toFixed(2);
 document.getElementById('frame').src=free
  ?'api/free_frame?az='+az+'&el='+el+'&r='+rad+'&channel='+ch+'&t='+Date.now()
  :'api/frame?view='+info.views[v]+'&channel='+ch+'&t='+Date.now()}
function mv(d){free=false;v=(v+d+info.views.length)%info.views.length;refresh()}
function togglefree(){free=!free;refresh()}
function orb(da,de,dr){az=(az+da+360)%360;el=Math.max(-85,Math.min(85,el+de));
 rad=Math.max(0.3,Math.min(8,rad+dr));refresh()}
document.addEventListener('keydown',e=>{if(!free)return;
 if(e.key=='ArrowLeft')orb(-15,0,0);else if(e.key=='ArrowRight')orb(15,0,0);
 else if(e.key=='ArrowUp')orb(0,10,0);else if(e.key=='ArrowDown')orb(0,-10,0);
 else if(e.key=='+'||e.key=='=')orb(0,0,-0.25);else if(e.key=='-')orb(0,0,0.25);
 else return;e.preventDefault()});
function clk(e){if(free)return;const im=e.target,r=im.getBoundingClientRect();
 const x=Math.floor((e.clientX-r.left)*im.naturalWidth/r.width);
 const y=Math.floor((e.clientY-r.top)*im.naturalHeight/r.height);
 im.src='api/click?view='+info.views[v]+'&y='+y+'&x='+x+'&t='+Date.now()}
async function train(){await fetch('api/train?epochs=1',{method:'POST'});
 const poll=setInterval(async()=>{const s=await (await fetch('api/info')).json();
  info=s;if(!s.training){clearInterval(poll)}refresh()},2000)}
load();
</script></body></html>"""


class ViewerState:
    """Shared trainer access: one lock serialises renders against training steps;
    rendered frames (and the embedding map for click queries) are cached per view
    and invalidated whenever a training epoch completes."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.lock = threading.Lock()
        self._cache: Dict[object, Dict[str, np.ndarray]] = {}
        self._train_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.last_losses: Dict[str, float] = {}
        ds = trainer.dataset
        self.views = sorted(set(np.asarray(ds.train_idxs).tolist())
                            | set(np.asarray(ds.val_idxs).tolist()))

    # ------------------------------------------------------------- rendering
    def channels_for_view(self, view: int) -> Dict[str, np.ndarray]:
        # hold the frames in a local: the training thread clears self._cache
        # after every epoch, so re-reading the dict after releasing the lock
        # could KeyError on an in-flight frame request
        frames = self._cache.get(view)
        if frames is None:
            with self.lock:
                frames = self._cache.get(view)
                if frames is None:
                    frames = render_channels_for_view(self.trainer, view)
                    self._cache[view] = frames
        return frames

    def frame(self, view: int, channel: str) -> Optional[np.ndarray]:
        return self.channels_for_view(view).get(channel)

    # the free camera: orbit poses keyed by (az, el, radius) rounded to the
    # page's step granularity.
    # The per-pose entries hold full channel maps (incl. the float32 [H, W, E]
    # embedding), so a page left orbiting would grow it without bound unless
    # the free-pose cache is LRU-bounded — training clears everything anyway.
    MAX_FREE_POSES = 16

    def free_frame(self, az: float, el: float, radius: float,
                   channel: str) -> Optional[np.ndarray]:
        key = ("free", round(az, 1), round(el, 1), round(radius, 2))
        frames = self._cache.get(key)
        if frames is not None:
            with self.lock:   # LRU: refresh recency so the pose being viewed
                if key in self._cache:   # survives an orbit sweep's evictions
                    self._cache[key] = self._cache.pop(key)
        else:
            with self.lock:
                frames = self._cache.get(key)
                if frames is None:
                    c2w = pose_from_orbit(az, el, radius)
                    frames = render_channels_for_pose(self.trainer, c2w)
                    free_keys = [k for k in self._cache
                                 if isinstance(k, tuple) and k[0] == "free"]
                    for old in free_keys[:max(0, len(free_keys) + 1
                                              - self.MAX_FREE_POSES)]:
                        self._cache.pop(old, None)   # dicts iterate in insertion order
                    self._cache[key] = frames
        return frames.get(channel)

    def click(self, view: int, y: int, x: int) -> Optional[np.ndarray]:
        emb = self.channels_for_view(view).get("_inst_embedding")
        if emb is None:
            return None
        h, w = emb.shape[:2]
        return embedding_distance_image(
            emb, (int(np.clip(y, 0, h - 1)), int(np.clip(x, 0, w - 1))))

    # -------------------------------------------------------------- training
    @property
    def training(self) -> bool:
        return self._train_thread is not None and self._train_thread.is_alive()

    def start_training(self, epochs: int) -> bool:
        if self.training:
            return False
        self._stop.clear()

        def run():
            t = self.trainer
            end = min(t.epoch + epochs, t.cfg.epochs)
            for epoch in range(t.epoch, end):
                if self._stop.is_set():
                    break
                with self.lock:
                    self.last_losses = t.run_epoch(epoch)
                self._cache.clear()   # frames are stale after every epoch

        self._train_thread = threading.Thread(target=run, daemon=True)
        self._train_thread.start()
        return True

    def stop_training(self):
        self._stop.set()


class _Handler(BaseHTTPRequestHandler):
    state: ViewerState  # set by make_server

    def log_message(self, *a):  # silence per-request stderr spam
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code=200):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        st = self.state
        if url.path in ("/", "/index.html"):
            return self._send(200, _PAGE.encode(), "text/html")
        if url.path == "/api/info":
            t = st.trainer
            return self._json({
                "views": st.views, "channels": list(CHANNELS),
                "epoch": int(t.epoch), "total_epochs": int(t.cfg.epochs),
                "training": st.training,
                "losses": {k: float(v) for k, v in st.last_losses.items()}})
        if url.path == "/api/frame":
            img = st.frame(int(q.get("view", st.views[0])), q.get("channel", "rgb"))
            if img is None:
                return self._json({"error": "channel unavailable"}, 404)
            return self._send(200, png_bytes(img), "image/png")
        if url.path == "/api/free_frame":
            img = st.free_frame(float(q.get("az", 0.0)), float(q.get("el", 20.0)),
                                float(q.get("r", 2.2)), q.get("channel", "rgb"))
            if img is None:
                return self._json({"error": "channel unavailable"}, 404)
            return self._send(200, png_bytes(img), "image/png")
        if url.path == "/api/click":
            img = st.click(int(q.get("view", st.views[0])),
                           int(q.get("y", 0)), int(q.get("x", 0)))
            if img is None:
                return self._json({"error": "no instance embeddings"}, 404)
            return self._send(200, png_bytes(img), "image/png")
        return self._json({"error": "not found"}, 404)

    def do_POST(self):
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        if url.path == "/api/train":
            started = self.state.start_training(int(q.get("epochs", 1)))
            return self._json({"started": started,
                               "training": self.state.training})
        if url.path == "/api/stop":
            self.state.stop_training()
            return self._json({"stopping": True})
        return self._json({"error": "not found"}, 404)


def make_server(trainer, host: str = "0.0.0.0",
                port: int = 0) -> Tuple[ThreadingHTTPServer, ViewerState]:
    """Build (but don't start) the viewer server; ``port=0`` picks a free port
    (read it back from ``server.server_address[1]``)."""
    state = ViewerState(trainer)
    handler = type("BoundHandler", (_Handler,), {"state": state})
    server = ThreadingHTTPServer((host, port), handler)
    return server, state


def serve(trainer, host: str = "0.0.0.0", port: int = 8080):
    """Serve until interrupted (``cli.py --viewer``)."""
    server, _ = make_server(trainer, host, port)
    actual = server.server_address[1]
    print(f"# viewer: http://{host}:{actual}/ (ctrl-c to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
