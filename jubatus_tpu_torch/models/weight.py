"""Weight engine driver (copy of ``jubatus_tpu/models/weight.py``).

Business API of the reference's weight service: update / calc_weight /
clear. ``update`` runs the converter's train path (recording document
frequencies); ``calc_weight`` the analyze path. Both return the named
features with their final weights (``DatumToFVConverter.convert_named``).
The driver resolves ``device`` as every driver of the port does (``cuda``
unless ``"cpu"`` is asked for, raising without CUDA), so that ``--device``
means the same for every engine; it holds no tensor.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

from jubatus_tpu_torch import resolve_device
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv import make_fv_converter
from jubatus_tpu_torch.framework.driver import DriverBase, locked


class WeightDriver(DriverBase):
    TYPE = "weight"

    def __init__(self, config: dict, dim_bits: int = 18, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        self.config_json = json.dumps(config)
        self.converter = make_fv_converter(config.get("converter"), dim_bits=dim_bits)

    @locked
    def update(self, d: Datum) -> List[Tuple[str, float]]:
        result = self.converter.convert_named(d, update_weights=True)
        self.event_model_updated()
        return sorted(result.items())

    @locked
    def calc_weight(self, d: Datum) -> List[Tuple[str, float]]:
        return sorted(self.converter.convert_named(d).items())

    @locked
    def clear(self) -> None:
        self.converter.weights.clear()
        self.update_count = 0

    def get_mixables(self):
        return {"weights": self.converter.weights}

    @locked
    def pack(self) -> Any:
        return {"weights": self.converter.weights.pack()}

    @locked
    def unpack(self, obj: Any) -> None:
        self.converter.weights.unpack(obj["weights"])

    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(num_features=self.converter.dim, device=str(self.device))
        return st
