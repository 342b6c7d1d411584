"""The viewer's websocket server and the HTTP server of its client.

Counterpart of ``samnerf_tpu/viewer/server.py``.  An asyncio
``websockets`` server runs on a daemon thread: incoming messages are
decoded and handed to the handlers registered for their type (a handler
that raises is reported and the connection stays open); outgoing
messages go to every client, and the latest message of each redundancy
key is kept and replayed to a client that joins later.  Port 0 binds a
free port; ``port`` then holds the one bound.
"""
from __future__ import annotations

import asyncio
import base64
import functools
import http.server
import io
import os
import threading
import traceback
from typing import Callable, Dict, List, Optional, Type

import numpy as np

from samnerf_tpu_torch.viewer import messages as m

CLIENT_DIR = os.path.join(os.path.dirname(__file__), "client")
"""The port's copy of the browser client."""


class ViewerServer:
    def __init__(self, host: str = "0.0.0.0", port: int = 7007):
        self.host = host
        self.port = port
        self._handlers: Dict[Type[m.Message], List[Callable]] = {}
        self._buffer: Dict[str, m.Message] = {}  # redundancy_key -> latest
        self._clients: set = set()
        self._sends: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stop_future: Optional[asyncio.Future] = None
        self._error: Optional[BaseException] = None

    def start(self, timeout: float = 10.0) -> None:
        """Start the server thread; returns once it listens, and raises
        what kept it from listening."""
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=timeout):
            raise TimeoutError(f"the viewer server did not start in {timeout} s")
        if self._error is not None:
            raise self._error

    def stop(self) -> None:
        """Close the server and join its thread; safe to call twice."""
        loop, fut = self._loop, self._stop_future
        if loop is not None and fut is not None:
            def _finish():
                if not fut.done():
                    fut.set_result(None)
            try:
                loop.call_soon_threadsafe(_finish)
            except RuntimeError:
                pass  # the loop is already closed
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self):
        try:
            asyncio.run(self._main())
        except Exception as e:      # reported by start()
            self._error = e
            self._started.set()

    async def _main(self):
        import websockets
        self._loop = asyncio.get_running_loop()
        self._stop_future = self._loop.create_future()
        async with websockets.serve(self._handle_client, self.host, self.port,
                                    max_size=None) as server:
            self.port = server.sockets[0].getsockname()[1]
            self._started.set()
            await self._stop_future

    async def _handle_client(self, ws):
        self._clients.add(ws)
        try:
            for msg in list(self._buffer.values()):
                await ws.send(msg.serialize())
            async for data in ws:
                try:
                    msg = m.Message.deserialize(data)
                except Exception:   # not a message of the protocol: dropped
                    continue
                for handler in self._handlers.get(type(msg), []):
                    try:
                        handler(msg)
                    except Exception:
                        traceback.print_exc()
        finally:
            self._clients.discard(ws)

    def register_handler(self, msg_type: Type[m.Message], handler: Callable) -> None:
        self._handlers.setdefault(msg_type, []).append(handler)

    def broadcast(self, msg: m.Message) -> None:
        """Keep ``msg`` as its key's latest and send it to every client."""
        self._buffer[msg.redundancy_key()] = msg
        if self._loop is None:
            return
        data = msg.serialize()

        def _send():
            for ws in list(self._clients):
                task = asyncio.ensure_future(ws.send(data))
                self._sends.add(task)
                task.add_done_callback(self._sent)

        try:
            self._loop.call_soon_threadsafe(_send)
        except RuntimeError:
            pass  # the loop is closed: the server has stopped

    def _sent(self, task: asyncio.Task) -> None:
        self._sends.discard(task)
        if not task.cancelled():
            task.exception()    # a client that left: nothing to report

    def set_background_image(self, image: np.ndarray, file_format: str = "jpeg",
                             quality: int = 70) -> None:
        """uint8 [H, W, 3] -> a base64 JPEG (or PNG) ``BackgroundImageMessage``."""
        from PIL import Image
        buf = io.BytesIO()
        pil = Image.fromarray(image)
        if file_format == "jpeg":
            pil.save(buf, format="JPEG", quality=quality)
            media = "image/jpeg"
        else:
            pil.save(buf, format="PNG")
            media = "image/png"
        self.broadcast(m.BackgroundImageMessage(
            media_type=media, base64_data=base64.b64encode(buf.getvalue()).decode("ascii")))

    def send_status_message(self, eval_res: str, step: int) -> None:
        self.broadcast(m.StatusMessage(eval_res=eval_res, step=step))

    def set_training_state(self, state: str) -> None:
        self.broadcast(m.TrainingStateMessage(training_state=state))

    def update_scene_box(self, aabb_min, aabb_max) -> None:
        self.broadcast(m.SceneBoxMessage(min=tuple(aabb_min), max=tuple(aabb_max)))

    def add_dataset_image(self, idx: str, json: dict) -> None:
        """One training camera's frustum and thumbnail."""
        self.broadcast(m.DatasetImageMessage(idx=idx, json=json))

    def send_file_path_info(self, config_base_dir: str, data_base_dir: str,
                            export_path_name: str) -> None:
        self.broadcast(m.FilePathInfoMessage(
            config_base_dir=str(config_base_dir), data_base_dir=str(data_base_dir),
            export_path_name=str(export_path_name)))

    def clear_sam_pins(self) -> None:
        self.broadcast(m.ClearSamPinsMessage())

    def update_fps(self, fps: float) -> None:
        self.broadcast(m.FPSMessage(fps=fps))


class _Quiet(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *a, **k):
        pass


def serve_client(http_port: int = 7008,
                 host: str = "0.0.0.0") -> http.server.ThreadingHTTPServer:
    """Serve the port's copy of the browser client over HTTP on a daemon
    thread: open ``http://<host>:<http_port>/?port=<websocket port>``.
    Returns the server (``server_address`` holds the bound port;
    ``shutdown()`` and ``server_close()`` end it)."""
    handler = functools.partial(_Quiet, directory=CLIENT_DIR)
    httpd = http.server.ThreadingHTTPServer((host, http_port), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
