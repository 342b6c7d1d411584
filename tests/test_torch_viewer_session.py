"""The port's viewer around a small model on the CPU.

- ``ViewerState.render_view`` of three client cameras with one click
  (the tiny 64x64 model and SAM decoder of ``test_torch_render_view.py``)
  against the JAX package's ``ViewerState.render_view``, whose
  ``params_fn`` returns the same weights: rgb, depth, the SAM and ClipSeg
  grids, ``masked_rgb`` and the locked points, with that file's
  tolerances: depth and accumulation rtol 1e-4, the grids atol 1e-4,
  locked points atol 1e-4, ``masked_rgb`` atol 1e-4 on >= 99.9 % of
  pixels (a mask logit near 0 may flip).
- One websocket session on the port (free port, timeouts on every
  receive, the viewer stopped in ``finally``): the scene box replayed to
  the new client, a frame, a SAM click that locks one 3D point, and a
  ``stop()`` that joins both threads.
- The train lock: a frame waits while a training step holds the lock, and
  renders without autograd once it is released.
"""
import base64
import io
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from samnerf_tpu.viewer import messages as jm
from samnerf_tpu.viewer import render_state_machine as jrsm
from samnerf_tpu.viewer import viewer_state as jvs
from samnerf_tpu_torch.viewer import messages as tm
from samnerf_tpu_torch.viewer import render_state_machine as trsm
from samnerf_tpu_torch.viewer import viewer_state as tvs
from samnerf_tpu_torch.utils.synthetic import look_at_c2w

from test_torch_render_view import GRID_TOL, renderers  # noqa: F401 (fixture)

SIZE = 64
RECV_TIMEOUT = 120.0     # seconds for a frame of the tiny model on one CPU core
EYES = ((0.6, 0.45, 0.5), (0.55, 0.5, 0.5), (0.5, 0.6, 0.45))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's torch work, restored after:
    the suite runs several test processes at once on the same cores,
    where each process's full thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _camera(mod, eye, xs=(), moving=False):
    """A client camera message whose pose is ``look_at_c2w(eye, 0)``: the
    client's matrix is column-major, and ``camera_from_message``'s two
    row swaps cancel, so its top rows are the c2w."""
    m = np.eye(4)
    m[:3] = look_at_c2w(np.asarray(eye), np.zeros(3))[:3]
    return mod.CameraMessage(aspect=1.0, render_aspect=1.0, fov=77.3196,
                             matrix=tuple(m.T.reshape(-1).tolist()),
                             camera_type="perspective", is_moving=moving, timestamp=0,
                             xs=list(xs), ys=[0.58] * len(xs))


def test_viewer_render_view_matches_jax(renderers):  # noqa: F811
    jsnr, params, snr = renderers
    jstate = jvs.ViewerState(jsnr, params_fn=lambda: params, cameras=None,
                             host="127.0.0.1", port=0)
    tstate = tvs.ViewerState(snr, cameras=None, host="127.0.0.1", port=0)
    snr.clear_prompts()
    jsnr.clear_prompts()
    for eye in EYES:
        jmsg, tmsg = _camera(jm, eye, xs=[0.31]), _camera(tm, eye, xs=[0.31])
        intrin, c2w = trsm.camera_from_message(tmsg, SIZE, SIZE)
        jintrin, jc2w = jrsm.camera_from_message(jmsg, SIZE, SIZE)
        np.testing.assert_array_equal(c2w, jc2w)
        points = trsm.get_prompt_points(tmsg, SIZE, SIZE)
        ref = jstate.render_view(jintrin, jc2w, SIZE, SIZE,
                                 points=jrsm.get_prompt_points(jmsg, SIZE, SIZE))
        out = tstate.render_view(intrin, c2w, SIZE, SIZE, points=points)
        for k, tol in (("depth", dict(rtol=1e-4, atol=1e-6)),
                       ("accumulation", dict(rtol=1e-4, atol=1e-6)),
                       ("rgb", GRID_TOL), ("sam", GRID_TOL), ("clipseg", GRID_TOL)):
            np.testing.assert_allclose(out[k], np.asarray(ref[k]), err_msg=k, **tol)
        close = np.abs(out["masked_rgb"] - np.asarray(ref["masked_rgb"])).max(-1) <= 1e-4
        assert close.mean() >= 0.999
        assert len(snr.prompts) == len(jsnr.prompts) == 1
    np.testing.assert_allclose(snr.prompts, jsnr.prompts, rtol=0, atol=1e-4)
    assert not np.array_equal(out["masked_rgb"], out["rgb"])


def _recv_until(ws, kind, timeout=RECV_TIMEOUT):
    """Messages until one of type ``kind`` arrives (returned with the
    others); raises after ``timeout`` seconds."""
    seen, deadline = [], time.time() + timeout
    while time.time() < deadline:
        try:
            msg = tm.Message.deserialize(ws.recv(timeout=max(deadline - time.time(), 0.1)))
        except TimeoutError:
            break
        seen.append(msg)
        if isinstance(msg, kind):
            return msg, seen
    raise AssertionError(f"no {kind.__name__} in {timeout} s; got "
                         f"{[type(s).__name__ for s in seen]}")


def _image(msg):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(msg.base64_data))))


def test_websocket_session(renderers):  # noqa: F811
    import websockets.sync.client as wsc

    _, _, snr = renderers
    snr.clear_prompts()
    state = tvs.ViewerState(snr, cameras=None, host="127.0.0.1", port=0, max_res=SIZE)
    try:
        state.start()
        state.init_scene()
        with wsc.connect(f"ws://127.0.0.1:{state.server.port}", max_size=None) as ws:
            box, _ = _recv_until(ws, tm.SceneBoxMessage)
            assert list(box.min) == [-1, -1, -1] and list(box.max) == [1, 1, 1]
            ws.send(_camera(tm, EYES[0]).serialize())
            frame, seen = _recv_until(ws, tm.BackgroundImageMessage)
            assert frame.media_type == "image/jpeg"
            assert _image(frame).shape == (SIZE, SIZE, 3)
            assert any(isinstance(s, tm.StatusMessage) for s in seen)
            ws.send(tm.GuiUpdateMessage(name="Output Render", value="masked_rgb").serialize())
            ws.send(tm.SamMessage(use_sam=True).serialize())
            # a queued rerender is never replaced, so the click's rerender can
            # be dropped behind the SAM toggle's; the client keeps sending its
            # camera with the click, and so does this one until it locks
            deadline = time.time() + RECV_TIMEOUT
            while snr.prompts is None and time.time() < deadline:
                ws.send(_camera(tm, EYES[0], xs=[0.31]).serialize())
                _recv_until(ws, tm.BackgroundImageMessage, deadline - time.time())
            assert snr.prompts is not None and len(snr.prompts) == 1
            assert state.output_render == "masked_rgb" and state.use_sam
    finally:
        state.stop()
    assert not state.render_machine.is_alive()
    assert state.server._thread is None


class _Recorder:
    """A renderer that records when it renders and whether grad mode was on."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def clear_prompts(self):
        pass

    def render_view(self, cam, idx, intrin, c2w, **kw):
        self.calls.append((time.time(), torch.is_grad_enabled()))
        return {"rgb": np.zeros((kw["height"], kw["width"], 3), np.float32)}


def test_a_frame_waits_for_the_train_lock():
    lock = threading.Lock()
    rec = _Recorder()
    state = tvs.ViewerState(rec, cameras=None, host="127.0.0.1", port=0,
                            train_lock=lock, max_res=32)
    try:
        with lock:                  # a training step in progress
            state.render_machine.start()
            state.render_machine.action(trsm.RenderAction("static", _camera(tm, EYES[0])))
            time.sleep(0.5)
            assert rec.calls == []
            released = time.time()
        deadline = time.time() + 10
        while not rec.calls and time.time() < deadline:
            time.sleep(0.01)
    finally:
        state.stop()
    assert rec.calls and rec.calls[0][0] >= released
    assert not any(grad for _, grad in rec.calls)
    assert "BackgroundImageMessage" in state.server._buffer
