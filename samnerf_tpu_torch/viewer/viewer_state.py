"""ViewerState: the websocket server, the interactive state, the control
panel and the render thread around one renderer.

Counterpart of ``samnerf_tpu/viewer/viewer_state.py``.  The renderer (a
:class:`~samnerf_tpu_torch.engine.render_pipeline.SamNerfRenderer`) holds
its model, so no parameter snapshot is passed: while training, the model
is the trainer's, whose optimizer updates it in place, and frames render
under ``train_lock``, which the trainer holds around each step.  Cameras
are built on the renderer's device; each frame runs without autograd
(grad mode is per thread).
"""
from __future__ import annotations

import atexit
import base64
import contextlib
import io
import json
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from samnerf_tpu_torch.engine.render_pipeline import cameras_from_intrin_c2w
from samnerf_tpu_torch.viewer import messages as m
from samnerf_tpu_torch.viewer.control_panel import ControlPanel
from samnerf_tpu_torch.viewer.render_state_machine import RenderAction, RenderStateMachine
from samnerf_tpu_torch.viewer.server import ViewerServer


def _camera_to_json(cameras, idx: int, image=None, max_size: int = 100) -> dict:
    """One training camera as the client's dataset-image dict: intrinsics,
    the 3x4 camera_to_world and, with ``image``, a JPEG thumbnail at most
    ``max_size`` on its long side as a data URL."""
    d = {
        "type": "PinholeCamera",
        "cx": float(cameras.cx.reshape(-1)[idx]),
        "cy": float(cameras.cy.reshape(-1)[idx]),
        "fx": float(cameras.fx.reshape(-1)[idx]),
        "fy": float(cameras.fy.reshape(-1)[idx]),
        "camera_to_world": cameras.camera_to_worlds[idx].tolist(),
        "camera_index": idx,
        "times": None,
    }
    if image is not None:
        from PIL import Image
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        pil = Image.fromarray(img)
        s = max_size / max(pil.size)
        if s < 1:
            pil = pil.resize((max(int(pil.size[0] * s), 1), max(int(pil.size[1] * s), 1)))
        buf = io.BytesIO()
        pil.save(buf, format="JPEG", quality=75)
        d["image"] = "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode("ascii")
    return d


class ViewerState:
    def __init__(self, renderer, cameras=None, host: str = "0.0.0.0", port: int = 7007,
                 train_lock: Optional[threading.Lock] = None, max_res: int = 512,
                 save_checkpoint_fn=None):
        """renderer: a ``SamNerfRenderer``; cameras: the training
        ``Cameras`` (shown by :meth:`init_scene`); port 0 binds a free
        port (``server.port`` after :meth:`start`); train_lock: held by the
        trainer around each step, taken by every frame."""
        self.renderer = renderer
        self.cameras = cameras
        self.server = ViewerServer(host=host, port=port)
        self.train_lock = train_lock
        self.save_checkpoint_fn = save_checkpoint_fn
        self.http = None
        """The client's HTTP server, when one is attached (stopped with
        the viewer)."""

        self.use_sam = False
        self.use_text_prompt = False
        self.use_search_text = False
        self.use_fixed_fps = False
        self.text_prompt = ""
        self.search_text = ""
        self.threshold = 0.5
        self.topk = 5
        self.n_points_sam = 0
        self.output_render = "rgb"
        self.max_res = max_res
        self.step = 0
        self.training_state = "training"
        self.camera_moving = False
        self.crop_enabled = False
        self.crop_min = np.array([-1.0, -1.0, -1.0], np.float32)
        self.crop_max = np.array([1.0, 1.0, 1.0], np.float32)
        self.crop_bg = np.array([38, 42, 55], np.float32) / 255.0
        self.camera_paths_dir = None
        """Where saved camera paths go (default: ``camera_paths`` in the
        temporary directory)."""

        self.render_machine = RenderStateMachine(self)

        s = self.server
        s.register_handler(m.CameraMessage, self._handle_camera_update)
        s.register_handler(m.SamMessage, self._sam_update)
        s.register_handler(m.ClearSamPinsMessage, self._clear_sam_pins)
        s.register_handler(m.TextPromptMessage, self._send_text_prompt)
        s.register_handler(m.ThresholdMessage, self._handle_threshold)
        s.register_handler(m.FPSMessage, self._handle_fps)
        s.register_handler(m.SearchTextMessage, self._handle_search_text)
        s.register_handler(m.TrainingStateMessage, self._handle_training_state)
        s.register_handler(m.SaveCheckpointMessage, self._handle_save_ckpt)
        s.register_handler(m.CropParamsMessage, self._handle_crop_params)
        s.register_handler(m.CameraPathPayloadMessage, self._handle_camera_path_payload)
        s.register_handler(m.CameraPathOptionsRequest, self._handle_camera_path_options)

        self.control_panel = ControlPanel(s, rerender_cb=self._rerender)
        p = self.control_panel
        p.on("Enable SAM", lambda v: self._sam_update(m.SamMessage(bool(v))))
        p.on("Clear SAM pins", lambda v: self._clear_sam_pins(m.ClearSamPinsMessage()))
        p.on("Send", lambda v: self._send_text_prompt(m.TextPromptMessage(p["Text Prompt"])))
        p.on("Clear", lambda v: self._send_text_prompt(m.TextPromptMessage("")))
        p.on("Threshold", lambda v: setattr(self, "threshold", float(v)))
        p.on("TopK", lambda v: setattr(self, "topk", int(v)))
        p.on("Output Render", lambda v: setattr(self, "output_render", v))
        p.on("Max Res", lambda v: setattr(self, "max_res", int(v)))
        for name in ("Crop Viewport", "Crop Min", "Crop Max", "Background color"):
            p.on(name, self._panel_crop_update)

    def start(self):
        """Start the server (raises if it cannot listen) and the render
        thread; :meth:`stop` also runs at exit."""
        self.server.start()
        self.render_machine.start()
        atexit.register(self.stop)

    def stop(self):
        """Stop and join the render thread, the websocket server and the
        client's HTTP server; safe to call twice."""
        rm = self.render_machine
        if rm.is_alive():
            rm.stop()
            rm.join(timeout=30)
        self.server.stop()
        if self.http is not None:
            self.http.shutdown()
            self.http.server_close()
            self.http = None

    def render_view(self, intrin, c2w, h, w, points=None, text_prompt=None, topk=5,
                    thresh=0.5, preset="static") -> Dict[str, np.ndarray]:
        """One frame of the renderer's ``render_view`` for a viewer camera,
        with the crop box when it is on."""
        cam = cameras_from_intrin_c2w(intrin, c2w, h, w, device=self.renderer.device)
        crop_aabb = crop_bg = None
        if self.crop_enabled:
            crop_aabb = np.stack([self.crop_min, self.crop_max])
            crop_bg = self.crop_bg
        with torch.no_grad():
            return self.renderer.render_view(
                cam, 0, intrin, c2w, points=points, text_prompt=text_prompt, topk=topk,
                thresh=thresh, width=w, height=h, crop_aabb=crop_aabb, crop_bg=crop_bg,
                preset=preset)

    def _handle_camera_update(self, msg: m.CameraMessage):
        self.camera_moving = msg.is_moving
        n_pins = len(msg.xs)
        if self.use_sam and n_pins != self.n_points_sam:
            self.n_points_sam = n_pins
            self.render_machine.action(RenderAction("rerender", msg))
        elif msg.is_moving:
            self.render_machine.action(RenderAction("move", msg))
        else:
            self.render_machine.action(RenderAction("static", msg))

    def _rerender(self):
        self.render_machine.action(RenderAction("rerender", self.render_machine.last_cam_msg))

    def _sam_update(self, msg: m.SamMessage):
        self.use_sam = msg.use_sam
        if not msg.use_sam:
            self.renderer.clear_prompts()
            self.n_points_sam = 0
        self._rerender()

    def _clear_sam_pins(self, msg: m.ClearSamPinsMessage):
        self.renderer.clear_prompts()
        self.n_points_sam = 0
        self.server.clear_sam_pins()
        self._rerender()

    def _send_text_prompt(self, msg: m.TextPromptMessage):
        self.text_prompt = msg.text_prompt
        self.use_text_prompt = bool(msg.text_prompt)
        self._rerender()

    def _handle_threshold(self, msg: m.ThresholdMessage):
        self.threshold = msg.threshold

    def _handle_fps(self, msg: m.FPSMessage):
        self.use_fixed_fps = msg.fps > 0

    def _handle_search_text(self, msg: m.SearchTextMessage):
        self.search_text = msg.text
        self.use_search_text = bool(msg.text)
        self.output_render = "clipseg_feature" if msg.switch_to_heat_map else "rgb"
        self._rerender()

    def _handle_training_state(self, msg: m.TrainingStateMessage):
        self.training_state = msg.training_state

    def _handle_save_ckpt(self, msg: m.SaveCheckpointMessage):
        """Save a checkpoint between two training steps."""
        if self.save_checkpoint_fn is not None:
            with self.train_lock if self.train_lock is not None else contextlib.nullcontext():
                self.save_checkpoint_fn(self.step)

    def _panel_crop_update(self, _value=None):
        p = self.control_panel
        self.crop_enabled = p.crop_viewport
        self.crop_min = np.asarray(p.crop_min, np.float32)
        self.crop_max = np.asarray(p.crop_max, np.float32)
        self.crop_bg = np.asarray(p.background_color, np.float32) / 255.0

    def _handle_crop_params(self, msg: m.CropParamsMessage):
        """The client's crop (centre and scale) -> min and max corners."""
        self.crop_enabled = bool(msg.crop_enabled)
        center = np.asarray(msg.crop_center, np.float32)
        scale = np.asarray(msg.crop_scale, np.float32)
        self.crop_min = center - scale / 2.0
        self.crop_max = center + scale / 2.0
        self.crop_bg = np.asarray(msg.crop_bg_color, np.float32) / 255.0
        self._rerender()

    def _paths_dir(self) -> Path:
        return Path(self.camera_paths_dir or Path(tempfile.gettempdir()) / "camera_paths")

    def _handle_camera_path_payload(self, msg: m.CameraPathPayloadMessage):
        """Save a client's camera path as ``<camera_paths_dir>/<name>.json``
        (``scripts/render.py --traj filename`` renders it)."""
        d = self._paths_dir()
        d.mkdir(parents=True, exist_ok=True)
        name = Path(str(msg.camera_path_filename)).name
        if not name.endswith(".json"):
            name += ".json"
        (d / name).write_text(json.dumps(msg.camera_path))

    def _handle_camera_path_options(self, msg: m.CameraPathOptionsRequest):
        """Send the saved camera paths back, by file name."""
        d = self._paths_dir()
        payload = {}
        if d.exists():
            for p in sorted(d.glob("*.json")):
                try:
                    payload[p.name] = json.loads(p.read_text())
                except (OSError, json.JSONDecodeError):
                    continue
        self.server.broadcast(m.CameraPathsMessage(payload=payload))

    def init_scene(self, aabb_min=(-1, -1, -1), aabb_max=(1, 1, 1), cameras=None,
                   images=None, max_display: int = 16, config_base_dir: str = "",
                   data_base_dir: str = "", export_path_name: str = ""):
        """Send the scene: the file paths, up to ``max_display`` training
        cameras (evenly spaced) with ``images`` (uint8 [N, H, W, 3]) as
        thumbnails, the scene box and the training state."""
        if config_base_dir or data_base_dir:
            self.server.send_file_path_info(config_base_dir, data_base_dir, export_path_name)
        if cameras is not None:
            n = int(cameras.camera_to_worlds.shape[0])
            idxs = np.linspace(0, n - 1, min(max_display, n), dtype=int)
            for i in np.unique(idxs):
                self.server.add_dataset_image(
                    f"{int(i):06d}",
                    _camera_to_json(cameras, int(i), None if images is None else images[i]))
        self.server.update_scene_box(aabb_min, aabb_max)
        self.server.set_training_state(self.training_state)

    def step_callback(self, step: int, metrics=None):
        """The trainer's per-step hook: a re-render every 30 steps, and a
        wait while the client has paused training."""
        self.step = step
        if step % 30 == 0 and self.render_machine.last_cam_msg is not None:
            self.render_machine.action(RenderAction("step", self.render_machine.last_cam_msg))
        while self.training_state == "paused":
            time.sleep(0.05)
