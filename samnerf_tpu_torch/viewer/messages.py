"""The viewer's wire protocol: typed messages serialized with msgpack.

Counterpart of ``samnerf_tpu/viewer/messages.py``, byte for byte: each
message is the msgpack map ``{"type": <class name>, **fields}`` (floats
single precision) that the client (``viewer/client/index.html``) speaks.
``redundancy_key`` names the latest-state slot a message fills in the
server's replay buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple, Type

import msgpack


_MESSAGE_TYPES: Dict[str, Type["Message"]] = {}


@dataclasses.dataclass
class Message:
    def redundancy_key(self) -> str:
        return type(self).__name__

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _MESSAGE_TYPES[cls.__name__] = cls

    def serialize(self) -> bytes:
        d = {"type": type(self).__name__}
        d.update(dataclasses.asdict(self))
        return msgpack.packb(d, use_single_float=True)

    @staticmethod
    def deserialize(data: bytes) -> "Message":
        d = msgpack.unpackb(data)
        t = d.pop("type")
        cls = _MESSAGE_TYPES.get(t)
        if cls is None:
            raise ValueError(f"unknown message type {t!r}")
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class BackgroundImageMessage(Message):
    media_type: str  # 'image/jpeg' | 'image/png'
    base64_data: str


@dataclasses.dataclass
class GuiAddMessage(Message):
    name: str
    folder_labels: Tuple[str, ...]
    leva_conf: Any

    def redundancy_key(self) -> str:
        return f"{type(self).__name__}_{self.name}"


@dataclasses.dataclass
class GuiRemoveMessage(Message):
    name: str


@dataclasses.dataclass
class GuiUpdateMessage(Message):
    name: str
    value: Any

    def redundancy_key(self) -> str:
        return f"{type(self).__name__}_{self.name}"


@dataclasses.dataclass
class GuiSetHiddenMessage(Message):
    name: str
    hidden: bool

    def redundancy_key(self) -> str:
        return f"{type(self).__name__}_{self.name}"


@dataclasses.dataclass
class GuiSetValueMessage(Message):
    name: str
    value: Any

    def redundancy_key(self) -> str:
        return f"{type(self).__name__}_{self.name}"


@dataclasses.dataclass
class GuiSetLevaConfMessage(Message):
    name: str
    leva_conf: Any

    def redundancy_key(self) -> str:
        return f"{type(self).__name__}_{self.name}"


@dataclasses.dataclass
class FilePathInfoMessage(Message):
    config_base_dir: str
    data_base_dir: str
    export_path_name: str


@dataclasses.dataclass
class CameraMessage(Message):
    """The client's camera and its accumulated SAM clicks (xs, ys in
    [0, 1])."""
    aspect: float
    render_aspect: float
    fov: float
    matrix: Tuple[float, ...]  # 16 floats, three.js column-major
    camera_type: str  # 'perspective' | 'fisheye' | 'equirectangular'
    is_moving: bool
    timestamp: int
    xs: List[float]
    ys: List[float]


@dataclasses.dataclass
class SceneBoxMessage(Message):
    min: Tuple[float, float, float]
    max: Tuple[float, float, float]


@dataclasses.dataclass
class DatasetImageMessage(Message):
    idx: str
    json: Any

    def redundancy_key(self) -> str:
        return f"{type(self).__name__}_{self.idx}"


@dataclasses.dataclass
class TrainingStateMessage(Message):
    training_state: str  # 'training' | 'paused' | 'completed'


@dataclasses.dataclass
class CameraPathPayloadMessage(Message):
    camera_path_filename: str
    camera_path: Any


@dataclasses.dataclass
class CameraPathOptionsRequest(Message):
    pass


@dataclasses.dataclass
class CameraPathsMessage(Message):
    payload: Any


@dataclasses.dataclass
class CropParamsMessage(Message):
    crop_enabled: bool
    crop_bg_color: Tuple[int, int, int]
    crop_center: Tuple[float, float, float]
    crop_scale: Tuple[float, float, float]


@dataclasses.dataclass
class StatusMessage(Message):
    eval_res: str
    step: int


@dataclasses.dataclass
class SaveCheckpointMessage(Message):
    pass


@dataclasses.dataclass
class UseTimeConditioningMessage(Message):
    pass


@dataclasses.dataclass
class TimeConditionMessage(Message):
    time: float


@dataclasses.dataclass
class SamMessage(Message):
    use_sam: bool


@dataclasses.dataclass
class ClearSamPinsMessage(Message):
    pass


@dataclasses.dataclass
class TextPromptMessage(Message):
    text_prompt: str


@dataclasses.dataclass
class ThresholdMessage(Message):
    threshold: float


@dataclasses.dataclass
class FPSMessage(Message):
    fps: float


@dataclasses.dataclass
class SearchTextMessage(Message):
    text: str
    switch_to_heat_map: bool
