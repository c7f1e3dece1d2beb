"""Live headless viewer: MJPEG stream + keyboard control over HTTP.

Port of `bez_isaacgym_tpu/viz/live.py`, which replaces the reference's
interactive Isaac Gym viewer and its keyboard events (vec_task.py:186-224
creates the viewer and subscribes QUIT / toggle_viewer_sync; :379-407 polls
events and pauses/steps the render loop).  A headless machine has no X
display, so the viewer is a tiny in-process HTTP server:

    viewer = LiveViewer(port=8080)        # prints the URL
    ...in the play loop:
    viewer.publish(model, physics_state)  # throttled MJPEG frame
    if viewer.quit_requested: break
    viewer.wait_if_paused()
    if viewer.pop_reset(): <re-reset envs>

Open http://<host>:<port>/ in any browser for the stream.  Keybindings
(mirroring the reference's viewer surface, plus pause/reset):

    ESC    quit the rollout            (reference QUIT, vec_task.py:200)
    V      toggle frame sync           (reference toggle_viewer_sync, :203)
    SPACE  pause / resume the rollout
    R      request an env reset

With sync off (V), the loop keeps running full speed and frames are simply
not rendered — the exact semantic of the reference's enable_viewer_sync
(vec_task.py:397-406: events still polled, gym.poll_viewer_events only).

Pure stdlib + matplotlib (imported when the first frame is drawn; the
server itself needs neither matplotlib nor a card); the server runs in a
daemon thread and never blocks the play loop (frames are rendered in the
loop, encoded to JPEG, and handed to waiting clients through a condition
variable).
"""

from __future__ import annotations

import io
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = b"""<!doctype html>
<html><head><title>bez_isaacgym_tpu_torch live viewer</title>
<style>body{background:#111;color:#ddd;font-family:monospace;text-align:center}
img{margin-top:1em;border:1px solid #444}</style></head>
<body>
<h3>bez_isaacgym_tpu_torch live viewer</h3>
<img src="/stream" width="640"/>
<p id="s">keys: ESC quit &middot; V toggle sync &middot; SPACE pause &middot; R reset</p>
<script>
document.addEventListener('keydown', e => {
  const k = {'Escape':'quit','v':'sync','V':'sync',' ':'pause','r':'reset',
             'R':'reset'}[e.key];
  if (k) { fetch('/key?k=' + k, {method:'POST'});
           document.getElementById('s').textContent = 'sent: ' + k; }
});
</script></body></html>
"""


class LiveViewer:
    """MJPEG viewer server + keyboard state (reference viewer parity)."""

    def __init__(self, port: int = 8080, fps: float = 15.0,
                 quiet: bool = False):
        self.quit_requested = False
        self.enable_viewer_sync = True   # vec_task.py:184 semantics
        self.paused = False
        self._reset_requested = False
        self._fps = fps
        self._last_render = 0.0
        self._frame: bytes | None = None
        self._cond = threading.Condition()
        self._seq = 0
        self._fig = None
        from collections import deque
        self._rewards: deque = deque(maxlen=600)   # last 10 s at 60 Hz

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # silence request spam
                pass

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)
                elif self.path.startswith("/frame"):
                    frame = viewer._latest_frame()
                    if frame is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.end_headers()
                    self.wfile.write(frame)
                elif self.path.startswith("/stream"):
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    seq = -1
                    try:
                        while not viewer.quit_requested:
                            with viewer._cond:
                                viewer._cond.wait_for(
                                    lambda: viewer._seq != seq
                                    or viewer.quit_requested, timeout=1.0)
                                frame, seq = viewer._frame, viewer._seq
                            if frame is None:
                                continue
                            self.wfile.write(b"--frame\r\n"
                                             b"Content-Type: image/jpeg\r\n\r\n")
                            self.wfile.write(frame)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                if self.path.startswith("/key"):
                    key = self.path.split("k=")[-1]
                    viewer._on_key(key)
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        if not quiet:
            print(f"live viewer: http://localhost:{self.port}/  "
                  f"(ESC quit, V sync, SPACE pause, R reset)")

    # --------------------------------------------------------------- events
    def _on_key(self, key: str) -> None:
        """Keyboard event dispatch (vec_task.py:379-391 event loop)."""
        if key == "quit":
            self.quit_requested = True
            with self._cond:
                self._cond.notify_all()
        elif key == "sync":
            self.enable_viewer_sync = not self.enable_viewer_sync
        elif key == "pause":
            self.paused = not self.paused
        elif key == "reset":
            self._reset_requested = True

    def pop_reset(self) -> bool:
        r, self._reset_requested = self._reset_requested, False
        return r

    def wait_if_paused(self, poll_s: float = 0.05) -> None:
        while self.paused and not self.quit_requested:
            time.sleep(poll_s)

    def _latest_frame(self):
        with self._cond:
            return self._frame

    # -------------------------------------------------------------- publish
    def publish(self, model, physics, extra_title: str = "",
                reward: float | None = None) -> bool:
        """Render + publish one frame if sync is on and the fps budget
        allows; returns True when a frame was actually pushed.

        reward: per-step reward of the displayed env — accumulated into a
        live reward strip under the 3D view (the reference's live debug
        reward plot, kick_env.py:230-238 streams matplotlib reward
        dashboards during stepping).  Rewards are recorded every call, even
        when the frame itself is fps-throttled."""
        if reward is not None:
            self._rewards.append(float(reward))
        if not self.enable_viewer_sync:
            return False
        now = time.monotonic()
        if now - self._last_render < 1.0 / self._fps:
            return False
        self._last_render = now
        self.publish_jpeg(self._render_jpeg(model, physics, extra_title))
        return True

    def publish_jpeg(self, data: bytes) -> None:
        with self._cond:
            self._frame = data
            self._seq += 1
            self._cond.notify_all()

    def _render_jpeg(self, model, physics, title: str = "") -> bytes:
        from bez_isaacgym_tpu_torch.viz.render import (render_frame,
                                                       require_matplotlib)

        require_matplotlib()
        import matplotlib.pyplot as plt

        if self._fig is None:
            self._fig = plt.figure(figsize=(6.4, 5.6), dpi=100)
            grid = self._fig.add_gridspec(5, 1)
            self._ax = self._fig.add_subplot(grid[:4], projection="3d")
            self._ax_r = self._fig.add_subplot(grid[4])
        self._ax.cla()
        render_frame(model, physics, ax=self._ax,
                     ball=physics.ball_pos is not None)
        if title:
            self._ax.set_title(title)
        if self._rewards:
            self._ax_r.cla()
            self._ax_r.plot(list(self._rewards), linewidth=0.8,
                            color="tab:green")
            self._ax_r.set_ylabel("reward", fontsize=7)
            self._ax_r.tick_params(labelsize=6)
            self._ax_r.margins(x=0)
        buf = io.BytesIO()
        self._fig.savefig(buf, format="jpeg")
        return buf.getvalue()

    def close(self) -> None:
        self.quit_requested = True
        with self._cond:
            self._cond.notify_all()
        self._server.shutdown()
        self._server.server_close()
        if self._fig is not None:
            import matplotlib.pyplot as plt
            plt.close(self._fig)
            self._fig = None
