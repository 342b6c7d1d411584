"""The viewer's control panel, declared by the server and drawn by the
client.

Counterpart of ``samnerf_tpu/viewer/control_panel.py``: each element goes
to the client as a ``GuiAddMessage`` (and ``GuiSetHiddenMessage`` when
hidden); the client's edits come back as ``GuiUpdateMessage``.  Enabling
SAM shows its controls, enabling the crop shows the crop's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from samnerf_tpu_torch.viewer import messages as m


@dataclasses.dataclass
class Element:
    name: str
    kind: str                      # checkbox | slider | dropdown | text | button | number | rgb | vec3
    value: Any = None
    options: Optional[List] = None
    hidden: bool = False
    cb: Optional[Callable[[Any], None]] = None

    def leva_conf(self) -> Dict:
        """The element's leva configuration, as the client reads it."""
        conf: Dict[str, Any] = {"label": self.name}
        if self.kind == "checkbox":
            conf["value"] = bool(self.value)
        elif self.kind == "slider":
            lo, hi, step = self.options or (0.0, 1.0, 0.01)
            conf.update(value=self.value, min=lo, max=hi, step=step)
        elif self.kind == "dropdown":
            conf.update(value=self.value, options=self.options)
        elif self.kind in ("text", "number"):
            conf["value"] = self.value
        elif self.kind == "rgb":
            r, g, b = self.value
            conf["value"] = {"r": r, "g": g, "b": b}
        elif self.kind == "vec3":
            x, y, z = self.value
            conf.update(value={"x": x, "y": y, "z": z}, step=0.05)
        elif self.kind == "button":
            conf["type"] = "BUTTON"
        return conf


# (the controls each toggle shows when on and hides when off)
_DEPENDENTS = {"Enable SAM": ("Clear SAM pins", "Text Prompt", "Threshold", "TopK",
                              "Send", "Clear"),
               "Crop Viewport": ("Background color", "Crop Min", "Crop Max")}


class ControlPanel:
    """The element tree and its sync with the clients through ``server``
    (a :class:`~samnerf_tpu_torch.viewer.server.ViewerServer`);
    ``rerender_cb`` runs after every edit."""

    def __init__(self, server, rerender_cb: Callable[[], None]):
        self.server = server
        self.rerender_cb = rerender_cb
        self.elements: Dict[str, Element] = {}
        self._register_defaults()
        server.register_handler(m.GuiUpdateMessage, self._on_update)

    def _register_defaults(self):
        self.add(Element("Output Render", "dropdown", "rgb",
                         ["rgb", "depth", "accumulation", "masked_rgb"]))
        self.add(Element("Colormap", "dropdown", "default",
                         ["default", "turbo", "viridis", "gray"]))
        self.add(Element("Train Util", "slider", 0.85, (0.0, 1.0, 0.05)))
        self.add(Element("Max Res", "slider", 512, (64, 2048, 64)))
        self.add(Element("Crop Viewport", "checkbox", False))
        self.add(Element("Background color", "rgb", (38, 42, 55), hidden=True))
        self.add(Element("Crop Min", "vec3", (-1.0, -1.0, -1.0), hidden=True))
        self.add(Element("Crop Max", "vec3", (1.0, 1.0, 1.0), hidden=True))
        self.add(Element("Enable SAM", "checkbox", False))
        self.add(Element("Clear SAM pins", "button", hidden=True))
        self.add(Element("Text Prompt", "text", "", hidden=True))
        self.add(Element("Threshold", "slider", 0.5, (0.0, 1.0, 0.01), hidden=True))
        self.add(Element("TopK", "number", 5, hidden=True))
        self.add(Element("Send", "button", hidden=True))
        self.add(Element("Clear", "button", hidden=True))

    def add(self, el: Element):
        self.elements[el.name] = el
        self.server.broadcast(m.GuiAddMessage(
            name=el.name, folder_labels=("Controls",), leva_conf=el.leva_conf()))
        if el.hidden:
            self.server.broadcast(m.GuiSetHiddenMessage(name=el.name, hidden=True))

    def __getitem__(self, name: str):
        return self.elements[name].value

    def set_value(self, name: str, value):
        self.elements[name].value = value
        self.server.broadcast(m.GuiSetValueMessage(name=name, value=value))

    def set_hidden(self, name: str, hidden: bool):
        self.elements[name].hidden = hidden
        self.server.broadcast(m.GuiSetHiddenMessage(name=name, hidden=hidden))

    def on(self, name: str, cb: Callable[[Any], None]):
        self.elements[name].cb = cb

    def _on_update(self, msg: m.GuiUpdateMessage):
        el = self.elements.get(msg.name)
        if el is None:
            return
        el.value = msg.value
        for dep in _DEPENDENTS.get(msg.name, ()):
            self.set_hidden(dep, not bool(msg.value))
        if el.cb is not None:
            el.cb(msg.value)
        self.rerender_cb()

    @property
    def crop_viewport(self) -> bool:
        return bool(self.elements["Crop Viewport"].value)

    @property
    def crop_min(self):
        v = self.elements["Crop Min"].value
        return (v["x"], v["y"], v["z"]) if isinstance(v, dict) else tuple(v)

    @property
    def crop_max(self):
        v = self.elements["Crop Max"].value
        return (v["x"], v["y"], v["z"]) if isinstance(v, dict) else tuple(v)

    @property
    def background_color(self):
        v = self.elements["Background color"].value
        return (v["r"], v["g"], v["b"]) if isinstance(v, dict) else tuple(v)
