"""Image feature extractor (copy of ``jubatus_tpu/plugins/image_feature.py``;
≙ plugin/src/fv_converter/image_feature.cpp) —
binary-rule plugin over image bytes, wraps OpenCV when installed.

config:
    "binary_types": {"image": {"method": "dynamic", "path": "image_feature",
                               "function": "create", "algorithm": "orb",
                               "resize": "true", "width": "64",
                               "height": "64"}},
    "binary_rules": [{"key": "image", "type": "image"}]

``orb`` emits the pooled ORB descriptor (256 dims, mean over keypoints);
``dense`` emits the resized grayscale pixel grid (the reference's RANDOM
dense sampler reduces to fixed-grid patches).
Feature names: ``<key>$<algorithm>/<i>``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple


class ImageFeature:
    def __init__(self, algorithm: str = "orb", resize: bool = False,
                 width: int = 64, height: int = 64) -> None:
        try:
            import cv2  # noqa: PLC0415
            import numpy as np  # noqa: PLC0415
        except ImportError as e:  # pragma: no cover - env without opencv
            raise RuntimeError(
                "image_feature requires the 'opencv-python' package") from e
        self.cv2 = cv2
        self.np = np
        if algorithm not in ("orb", "dense"):
            raise ValueError(f"unknown image_feature algorithm {algorithm!r}")
        self.algorithm = algorithm
        self.resize = resize
        self.size = (int(width), int(height))

    def _decode(self, data: bytes):
        buf = self.np.frombuffer(data, dtype=self.np.uint8)
        img = self.cv2.imdecode(buf, self.cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise ValueError("image_feature: cannot decode image bytes")
        if self.resize:
            img = self.cv2.resize(img, self.size)
        return img

    def extract(self, key: str, data: bytes) -> Iterable[Tuple[str, float]]:
        img = self._decode(data)
        out: List[Tuple[str, float]] = []
        if self.algorithm == "orb":
            orb = self.cv2.ORB_create()
            _kp, desc = orb.detectAndCompute(img, None)
            if desc is None or not len(desc):
                return out
            pooled = desc.astype("float32").mean(axis=0) / 255.0
            for i, v in enumerate(pooled):
                out.append((f"{key}$orb/{i}", float(v)))
        else:  # dense pixel grid
            grid = (img if self.resize
                    else self.cv2.resize(img, self.size)).astype("float32") / 255.0
            for i, v in enumerate(grid.reshape(-1)):
                out.append((f"{key}$dense/{i}", float(v)))
        return out


def create(params: Dict[str, str]) -> ImageFeature:
    return ImageFeature(
        algorithm=params.get("algorithm", "orb"),
        resize=params.get("resize", "false") == "true",
        width=int(params.get("width", "64")),
        height=int(params.get("height", "64")),
    )
