"""The viewer's render thread: camera actions in, frames out.

Counterpart of ``samnerf_tpu/viewer/render_state_machine.py``: the states
low_move, low_static and high with the same transition table; the
dynamic resolution from the measured rays per second against a 24 fps
target, bucketed to multiples of ``res_step`` (32); the fixed-fps
override; a moving camera renders through the "move" preset (halved
sample counts); a low_static frame triggers its own upgrade to high.
A frame is rendered whole: a newer action waits for the next frame.
Frames render under the viewer's ``train_lock`` and without autograd.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from samnerf_tpu_torch.core.camera_paths import three_js_perspective_camera_focal_length
from samnerf_tpu_torch.utils.colormaps import apply_colormap
from samnerf_tpu_torch.viewer import messages as m

RENDER_STATES = ("low_move", "low_static", "high")
RENDER_ACTIONS = ("rerender", "move", "static", "step")


def get_prompt_points(cam_msg: m.CameraMessage, image_height: int,
                      image_width: int) -> np.ndarray:
    """The message's normalised clicks -> int32 pixel (x, y) [N, 2]."""
    xs = (np.array(cam_msg.xs) * image_width).astype(np.int32)
    ys = (np.array(cam_msg.ys) * image_height).astype(np.int32)
    return np.stack([xs, ys], axis=-1)


def camera_from_message(cam_msg: m.CameraMessage, image_height: int,
                        image_width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(intrinsics [3, 3], c2w [3, 4]) from the three.js camera message: its
    column-major matrix with the y and z rows swapped (y-up to z-up), then
    the c2w rows reordered as the reference's state machine does."""
    focal = three_js_perspective_camera_focal_length(cam_msg.fov, image_height)
    intrin = np.array([[focal, 0, image_width / 2.0],
                       [0, focal, image_height / 2.0],
                       [0, 0, 1.0]], np.float32)
    mat = np.array(cam_msg.matrix, np.float32).reshape(4, 4).T
    mat = mat[[0, 2, 1, 3], :]
    c2w = mat[:3, :]
    c2w = c2w[[0, 2, 1], :]
    return intrin, c2w


@dataclasses.dataclass
class RenderAction:
    action: str
    cam_msg: Optional[m.CameraMessage]
    use_fixed_fps: bool = False


class RenderStateMachine(threading.Thread):
    """The render thread of a
    :class:`~samnerf_tpu_torch.viewer.viewer_state.ViewerState`."""

    def __init__(self, viewer_state, target_fps: int = 24, res_step: int = 32):
        super().__init__(daemon=True)
        self.transitions = {s: {a: s for a in RENDER_ACTIONS} for s in RENDER_STATES}
        self.transitions["low_move"]["static"] = "low_static"
        self.transitions["low_static"]["static"] = "high"
        self.transitions["low_static"]["step"] = "high"
        self.transitions["low_static"]["move"] = "low_move"
        self.transitions["high"]["move"] = "low_move"
        self.transitions["high"]["rerender"] = "low_static"
        self.state = "low_static"
        self.next_action: Optional[RenderAction] = None
        self.render_trigger = threading.Event()
        self.target_fps = target_fps
        self.res_step = res_step
        self.viewer = viewer_state
        self.last_cam_msg: Optional[m.CameraMessage] = None
        self.render_times = deque([], maxlen=3)
        self.vis_rays_per_sec = 100000.0
        # not ``_stop``: that name is a method of threading.Thread
        self._stop_requested = False

    def action(self, action: RenderAction):
        """Queue ``action`` as the next one.  A "step" does not replace a
        queued move, static or rerender (nor act while the camera moves),
        and nothing replaces a queued rerender."""
        if self.next_action is None:
            self.next_action = action
        elif action.action == "step" and (
                self.state == "low_move"
                or self.next_action.action in ("move", "static", "rerender")):
            return
        elif self.next_action.action == "rerender":
            pass
        else:
            self.next_action = action
        self.render_trigger.set()

    def stop(self):
        self._stop_requested = True
        self.render_trigger.set()

    def run(self):
        while not self._stop_requested:
            self.render_trigger.wait(timeout=0.1)
            if self._stop_requested:
                return
            action = self.next_action
            self.render_trigger.clear()
            self.next_action = None
            if action is None:
                continue
            if action.cam_msg is None and self.last_cam_msg is None:
                continue
            self.state = self.transitions[self.state][action.action]
            try:
                outputs, res = self._render_img(action)
                if self._stop_requested:
                    return
                self._send_output_to_viewer(outputs, res)
            except Exception:   # a failed frame is reported; the thread goes on
                if self._stop_requested or sys.is_finalizing():
                    return
                traceback.print_exc()
            if self.state == "low_static":
                self.action(RenderAction("static", self.last_cam_msg))

    def _calculate_image_res(self, aspect_ratio: float) -> Tuple[int, int]:
        """(height, width): ``max_res`` on the long side in high; in the low
        states as many rays as the measured rate renders at the target fps
        (at least 30 rows); ``max_res`` tall with fixed fps; each side
        bucketed down to a multiple of ``res_step``."""
        max_res = self.viewer.max_res
        if self.state == "high":
            image_height = max_res
            image_width = int(image_height * aspect_ratio)
            if image_width > max_res:
                image_width = max_res
                image_height = int(image_width / aspect_ratio)
        else:
            num_vis_rays = self.vis_rays_per_sec / self.target_fps
            image_height = int((num_vis_rays / aspect_ratio) ** 0.5)
            image_height = max(min(max_res, image_height), 30)
            image_width = int(image_height * aspect_ratio)
            if image_width > max_res:
                image_width = max_res
                image_height = int(image_width / aspect_ratio)
        if self.viewer.use_fixed_fps:
            image_height = max_res
            image_width = int(image_height * aspect_ratio)
        step = self.res_step
        image_height = max(step, (image_height // step) * step)
        image_width = max(step, (image_width // step) * step)
        return image_height, image_width

    def _render_img(self, action: RenderAction):
        cam_msg = action.cam_msg if action.cam_msg is not None else self.last_cam_msg
        self.last_cam_msg = cam_msg
        v = self.viewer
        h, w = self._calculate_image_res(cam_msg.aspect)
        intrin, c2w = camera_from_message(cam_msg, h, w)

        points = None
        text_prompt = None
        threshold, topk = 0.0, 0
        if v.use_sam:
            points = get_prompt_points(cam_msg, h, w)
        if v.use_text_prompt:
            text_prompt, threshold, topk = v.text_prompt, v.threshold, int(v.topk)
        if v.use_search_text:
            text_prompt, points = v.search_text, None
            threshold, topk = v.threshold, int(v.topk)

        t0 = time.time()
        preset = "move" if self.state == "low_move" else "static"
        lock = v.train_lock if v.train_lock is not None else contextlib.nullcontext()
        with lock:
            outputs = v.render_view(intrin, c2w, h, w, points=points,
                                    text_prompt=text_prompt, topk=topk,
                                    thresh=threshold, preset=preset)
        dt = max(time.time() - t0, 1e-6)
        self.render_times.append(dt)
        self.vis_rays_per_sec = 0.8 * self.vis_rays_per_sec + 0.2 * (h * w / dt)
        v.server.send_status_message(eval_res=f"{h}x{w}px", step=v.step)
        return outputs, (h, w)

    def _send_output_to_viewer(self, outputs: Dict[str, np.ndarray], res):
        """The selected output (``rgb`` when the frame lacks it; one
        channel through the turbo colormap) as a quality-70 JPEG."""
        v = self.viewer
        key = v.output_render if v.output_render in outputs else "rgb"
        img = outputs[key]
        if img.shape[-1] == 1:
            img = apply_colormap(img)
        img_u8 = (np.clip(np.asarray(img, np.float32), 0, 1) * 255).astype(np.uint8)
        v.server.set_background_image(img_u8, file_format="jpeg")
        if self.render_times:
            v.server.update_fps(1.0 / np.mean(self.render_times))
