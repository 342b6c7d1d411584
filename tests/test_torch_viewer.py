"""The port's viewer modules against the JAX package's on the CPU: the
wire protocol, the camera and click conversions, the render state
machine's table, actions and resolutions, the control panel, the
handlers' state changes, the training-camera JSON, the colormaps and the
client's HTTP server.  No model renders here (see
``test_torch_viewer_session.py``).  Everything is held exactly: the
bytes on the wire, the numpy arrays, the state after each message.
"""
import dataclasses
import urllib.request

import msgpack
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from samnerf_tpu.core.cameras import Cameras as JaxCameras
from samnerf_tpu.utils import colormaps as jcm
from samnerf_tpu.viewer import messages as jm
from samnerf_tpu.viewer import render_state_machine as jrsm
from samnerf_tpu.viewer import viewer_state as jvs
from samnerf_tpu_torch.core.cameras import Cameras
from samnerf_tpu_torch.utils import colormaps as tcm
from samnerf_tpu_torch.viewer import messages as tm
from samnerf_tpu_torch.viewer import render_state_machine as trsm
from samnerf_tpu_torch.viewer import server as tserver
from samnerf_tpu_torch.viewer import viewer_state as tvs


def _matrix(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = q, rng.normal(size=3)
    return tuple(m.T.reshape(-1).tolist())


def _examples(mod):
    """One instance of every message class of ``mod`` (same field values
    in both packages)."""
    return [
        mod.BackgroundImageMessage(media_type="image/jpeg", base64_data="QUJD"),
        mod.GuiAddMessage(name="Max Res", folder_labels=("Controls",),
                          leva_conf={"label": "Max Res", "value": 512, "min": 64}),
        mod.GuiRemoveMessage(name="Send"),
        mod.GuiUpdateMessage(name="Threshold", value=0.25),
        mod.GuiSetHiddenMessage(name="TopK", hidden=True),
        mod.GuiSetValueMessage(name="Text Prompt", value="a ball"),
        mod.GuiSetLevaConfMessage(name="TopK", leva_conf={"value": 3}),
        mod.FilePathInfoMessage(config_base_dir="/a", data_base_dir="/b",
                                export_path_name="c"),
        mod.CameraMessage(aspect=1.5, render_aspect=1.25, fov=50.3, matrix=_matrix(0),
                          camera_type="perspective", is_moving=True, timestamp=12,
                          xs=[0.25, 0.7], ys=[0.5, 0.125]),
        mod.SceneBoxMessage(min=(-1.0, -1.0, -1.0), max=(1.0, 1.0, 1.0)),
        mod.DatasetImageMessage(idx="000003", json={"fx": 100.5, "camera_index": 3}),
        mod.TrainingStateMessage(training_state="paused"),
        mod.CameraPathPayloadMessage(camera_path_filename="loop",
                                     camera_path={"render_height": 64, "fps": 24.0}),
        mod.CameraPathOptionsRequest(),
        mod.CameraPathsMessage(payload={"loop.json": {"seconds": 1}}),
        mod.CropParamsMessage(crop_enabled=True, crop_bg_color=(1, 2, 3),
                              crop_center=(0.1, 0.2, 0.3), crop_scale=(1.0, 1.5, 2.0)),
        mod.StatusMessage(eval_res="64x64px", step=7),
        mod.SaveCheckpointMessage(),
        mod.UseTimeConditioningMessage(),
        mod.TimeConditionMessage(time=0.3),
        mod.SamMessage(use_sam=True),
        mod.ClearSamPinsMessage(),
        mod.TextPromptMessage(text_prompt="a red ball"),
        mod.ThresholdMessage(threshold=0.7),
        mod.FPSMessage(fps=24.0),
        mod.SearchTextMessage(text="ball", switch_to_heat_map=True),
    ]


def test_every_message_class_is_ported():
    names = {type(msg).__name__ for msg in _examples(jm)}
    assert names == set(jm._MESSAGE_TYPES) == set(tm._MESSAGE_TYPES)
    assert len(names) == 26


@pytest.mark.parametrize("i", range(26))
def test_message_bytes_match_jax_and_round_trip(i):
    j, t = _examples(jm)[i], _examples(tm)[i]
    data = t.serialize()
    assert data == j.serialize()
    assert t.redundancy_key() == j.redundancy_key()
    back = tm.Message.deserialize(data)
    assert type(back) is type(t)
    # msgpack decodes tuples as lists and floats at single precision
    assert back.serialize() == data
    assert msgpack.unpackb(data)["type"] == type(t).__name__
    assert type(tm.Message.deserialize(j.serialize())) is type(t)


def test_unknown_message_type_raises_as_jax():
    data = msgpack.packb({"type": "NoSuchMessage"})
    for mod in (jm, tm):
        with pytest.raises(ValueError, match="NoSuchMessage"):
            mod.Message.deserialize(data)


@pytest.mark.parametrize("seed", range(4))
def test_camera_from_message_and_prompt_points_match_jax(seed):
    rng = np.random.default_rng(seed)
    fields = dict(aspect=float(rng.uniform(0.5, 2.0)), render_aspect=1.0,
                  fov=float(rng.uniform(20, 90)), matrix=_matrix(seed),
                  camera_type="perspective", is_moving=False, timestamp=0,
                  xs=rng.uniform(0, 1, 3).tolist(), ys=rng.uniform(0, 1, 3).tolist())
    j, t = jm.CameraMessage(**fields), tm.CameraMessage(**fields)
    for h, w in ((64, 96), (512, 384)):
        ji, jc = jrsm.camera_from_message(j, h, w)
        ti, tc = trsm.camera_from_message(t, h, w)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(trsm.get_prompt_points(t, h, w),
                                      jrsm.get_prompt_points(j, h, w))
    assert trsm.three_js_perspective_camera_focal_length(None, 64) == 50.0


@dataclasses.dataclass
class _View:
    """What the state machine reads of its viewer."""
    max_res: int = 512
    use_fixed_fps: bool = False


def test_transition_table_matches_jax():
    j, t = jrsm.RenderStateMachine(_View()), trsm.RenderStateMachine(_View())
    assert t.transitions == j.transitions
    assert (trsm.RENDER_STATES, trsm.RENDER_ACTIONS) == (jrsm.RENDER_STATES,
                                                         jrsm.RENDER_ACTIONS)
    assert t.state == j.state == "low_static"


@pytest.mark.parametrize("state", ("low_move", "low_static", "high"))
@pytest.mark.parametrize("fixed", (False, True))
def test_calculate_image_res_matches_jax(state, fixed):
    for max_res in (64, 512, 2048):
        view = _View(max_res=max_res, use_fixed_fps=fixed)
        j, t = jrsm.RenderStateMachine(view), trsm.RenderStateMachine(view)
        for aspect in (0.3, 0.75, 1.0, 1.3333, 2.5):
            for rate in (1e3, 1e5, 2.4e6, 1e8):
                j.state = t.state = state
                j.vis_rays_per_sec = t.vis_rays_per_sec = rate
                got = t._calculate_image_res(aspect)
                assert got == j._calculate_image_res(aspect)
                assert got[0] % 32 == 0 and got[1] % 32 == 0


def _action_names(machine):
    a = machine.next_action
    return None if a is None else (a.action, a.cam_msg)


def test_action_queueing_matches_jax():
    """Every pair (queued action, new action) in every state."""
    for state in jrsm.RENDER_STATES:
        for first in (None,) + jrsm.RENDER_ACTIONS:
            for second in jrsm.RENDER_ACTIONS:
                out = []
                for mod in (jrsm, trsm):
                    sm = mod.RenderStateMachine(_View())
                    sm.state = state
                    if first is not None:
                        sm.action(mod.RenderAction(first, "m1"))
                    sm.action(mod.RenderAction(second, "m2"))
                    out.append((_action_names(sm), sm.render_trigger.is_set()))
                assert out[0] == out[1], (state, first, second)


class _Renderer:
    """The renderer calls the handlers make."""

    def __init__(self):
        self.cleared = 0

    def clear_prompts(self):
        self.cleared += 1


def _states():
    """(JAX viewer state, port viewer state), neither started."""
    j = jvs.ViewerState(_Renderer(), params_fn=lambda: None, cameras=None,
                        host="127.0.0.1", port=0)
    t = tvs.ViewerState(_Renderer(), cameras=None, host="127.0.0.1", port=0)
    return j, t


_STATE_FIELDS = ("use_sam", "use_text_prompt", "use_search_text", "use_fixed_fps",
                 "text_prompt", "search_text", "threshold", "topk", "n_points_sam",
                 "output_render", "max_res", "step", "training_state", "camera_moving",
                 "crop_enabled")


def _snapshot(state):
    snap = {k: getattr(state, k) for k in _STATE_FIELDS}
    snap.update(crop_min=state.crop_min.tolist(), crop_max=state.crop_max.tolist(),
                crop_bg=state.crop_bg.tolist(), cleared=state.renderer.cleared,
                action=(None if state.render_machine.next_action is None
                        else state.render_machine.next_action.action),
                buffer={k: v.serialize() for k, v in state.server._buffer.items()},
                panel={k: (e.value, e.hidden) for k, e in state.control_panel.elements.items()})
    return snap


def _camera(mod, xs=(), moving=False):
    return mod.CameraMessage(aspect=1.0, render_aspect=1.0, fov=50.0, matrix=_matrix(3),
                             camera_type="perspective", is_moving=moving, timestamp=0,
                             xs=list(xs), ys=[0.5] * len(xs))


def _script(mod):
    """A session's messages, in order, for the package ``mod``."""
    return [
        _camera(mod),
        mod.SamMessage(use_sam=True),
        _camera(mod, xs=[0.25]),
        _camera(mod, xs=[0.25], moving=True),
        mod.GuiUpdateMessage(name="Enable SAM", value=True),
        mod.GuiUpdateMessage(name="Output Render", value="masked_rgb"),
        mod.GuiUpdateMessage(name="Threshold", value=0.3),
        mod.GuiUpdateMessage(name="TopK", value=7),
        mod.GuiUpdateMessage(name="Max Res", value=256),
        mod.GuiUpdateMessage(name="Text Prompt", value="the table"),
        mod.GuiUpdateMessage(name="Send", value=True),
        mod.TextPromptMessage(text_prompt="a red ball"),
        mod.ThresholdMessage(threshold=0.65),
        mod.FPSMessage(fps=24.0),
        mod.SearchTextMessage(text="ball", switch_to_heat_map=True),
        mod.ClearSamPinsMessage(),
        mod.GuiUpdateMessage(name="Crop Viewport", value=True),
        mod.GuiUpdateMessage(name="Crop Min", value={"x": -0.5, "y": -0.25, "z": -1.0}),
        mod.GuiUpdateMessage(name="Background color", value={"r": 10, "g": 20, "b": 30}),
        mod.CropParamsMessage(crop_enabled=True, crop_bg_color=(5, 6, 7),
                              crop_center=(0.1, 0.2, 0.3), crop_scale=(1.0, 1.5, 2.0)),
        mod.TrainingStateMessage(training_state="paused"),
        mod.TrainingStateMessage(training_state="training"),
        mod.SearchTextMessage(text="", switch_to_heat_map=False),
        mod.TextPromptMessage(text_prompt=""),
        mod.GuiUpdateMessage(name="Clear", value=True),
        mod.GuiUpdateMessage(name="No such element", value=1),
        mod.SamMessage(use_sam=False),
        mod.FPSMessage(fps=0.0),
    ]


_HANDLED = (
    "CameraMessage", "SamMessage", "ClearSamPinsMessage", "TextPromptMessage",
    "ThresholdMessage", "FPSMessage", "SearchTextMessage", "TrainingStateMessage",
    "CropParamsMessage", "GuiUpdateMessage")


def _dispatch(state, msg):
    for handler in state.server._handlers[type(msg)]:
        handler(msg)


def test_control_panel_messages_match_jax():
    j, t = _states()
    assert list(t.server._buffer) == list(j.server._buffer)
    assert _snapshot(t)["buffer"] == _snapshot(j)["buffer"]
    assert {k: e.leva_conf() for k, e in t.control_panel.elements.items()} == \
        {k: e.leva_conf() for k, e in j.control_panel.elements.items()}
    hidden = [k for k, e in t.control_panel.elements.items() if e.hidden]
    assert "Clear SAM pins" in hidden and "Crop Min" in hidden


def test_handlers_change_state_as_jax():
    j, t = _states()
    for jmsg, tmsg in zip(_script(jm), _script(tm)):
        assert type(tmsg).__name__ in _HANDLED
        _dispatch(j, jmsg)
        _dispatch(t, tmsg)
        assert _snapshot(t) == _snapshot(j), type(tmsg).__name__
    assert t.renderer.cleared == 2


def test_camera_path_payload_and_options_match_jax(tmp_path):
    payload = {"camera_type": "perspective", "render_height": 64, "render_width": 48,
               "camera_path": [{"camera_to_world": list(np.eye(4).reshape(-1)), "fov": 50.0}]}
    j, t = _states()
    j.camera_paths_dir, t.camera_paths_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    for state, mod in ((j, jm), (t, tm)):
        _dispatch(state, mod.CameraPathPayloadMessage(camera_path_filename="../loop",
                                                      camera_path=payload))
        _dispatch(state, mod.CameraPathOptionsRequest())
    assert (tmp_path / "port" / "loop.json").read_text() == \
        (tmp_path / "jax" / "loop.json").read_text()
    assert t.server._buffer["CameraPathsMessage"].serialize() == \
        j.server._buffer["CameraPathsMessage"].serialize()
    assert list(t.server._buffer["CameraPathsMessage"].payload) == ["loop.json"]


def test_save_checkpoint_and_step_callback_match_jax():
    j, t = _states()
    saved = {"jax": [], "port": []}
    j.save_checkpoint_fn = saved["jax"].append
    t.save_checkpoint_fn = saved["port"].append
    for state, mod in ((j, jm), (t, tm)):
        state.step_callback(29)
        assert state.render_machine.next_action is None     # no camera yet
        state.render_machine.last_cam_msg = _camera(mod)
        state.step_callback(30)
        _dispatch(state, mod.SaveCheckpointMessage())
    assert saved["port"] == saved["jax"] == [30]
    assert t.render_machine.next_action.action == j.render_machine.next_action.action == "step"


def test_camera_to_json_and_init_scene_match_jax():
    rng = np.random.default_rng(0)
    c2w = rng.normal(size=(3, 3, 4)).astype(np.float32)
    f = rng.uniform(50, 100, (3, 1)).astype(np.float32)
    jc = JaxCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(f), fy=jnp.asarray(f + 1),
                    cx=jnp.full((3, 1), 32.0), cy=jnp.full((3, 1), 24.0), width=64, height=48)
    tc = Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.from_numpy(f),
                 fy=torch.from_numpy(f + 1), cx=torch.full((3, 1), 32.0),
                 cy=torch.full((3, 1), 24.0), width=64, height=48)
    images = (rng.uniform(size=(3, 48, 64, 3)) * 255).astype(np.uint8)
    for i in range(3):
        assert tvs._camera_to_json(tc, i, images[i]) == jvs._camera_to_json(jc, i, images[i])
    assert tvs._camera_to_json(tc, 1) == jvs._camera_to_json(jc, 1)
    j, t = _states()
    kw = dict(images=images, config_base_dir="/out", data_base_dir="/data",
              export_path_name="run")
    j.init_scene(cameras=jc, **kw)
    t.init_scene(cameras=tc, **kw)
    assert _snapshot(t)["buffer"] == _snapshot(j)["buffer"]
    assert "DatasetImageMessage_000002" in t.server._buffer


def test_colormaps_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(16, 12, 1)).astype(np.float32)
    np.testing.assert_array_equal(tcm.apply_colormap(v), jcm.apply_colormap(v))
    np.testing.assert_array_equal(tcm.apply_colormap(np.ones_like(v)),
                                  jcm.apply_colormap(np.ones_like(v)))
    u = rng.uniform(-0.2, 1.2, (16, 12, 1)).astype(np.float32)
    np.testing.assert_array_equal(tcm.apply_float_colormap(u), jcm.apply_float_colormap(u))
    acc = rng.uniform(size=(16, 12, 1)).astype(np.float32)
    np.testing.assert_array_equal(tcm.apply_depth_colormap(v, acc),
                                  jcm.apply_depth_colormap(v, acc))


def test_serve_client_serves_the_ports_copy():
    httpd = tserver.serve_client(http_port=0, host="127.0.0.1")
    try:
        port = httpd.server_address[1]
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert tserver.CLIENT_DIR.startswith(str(tserver.__file__).rsplit("/", 1)[0])
    with open(f"{tserver.CLIENT_DIR}/index.html", "rb") as f:
        assert body == f.read()
    assert b"CameraMessage" in body and b"SearchTextMessage" in body
