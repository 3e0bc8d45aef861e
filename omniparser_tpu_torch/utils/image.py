"""Image codec helpers (host-side).  PIL and cv2 are imported inside the
functions that decode or encode, so the package imports without them."""

from __future__ import annotations

import base64
import io

import numpy as np


def decode_base64_image(image_base64: str) -> np.ndarray:
    """base64 PNG/JPEG -> RGB uint8 [H, W, 3] (RGBA flattened, like
    util/utils.py:507-509)."""
    from PIL import Image

    raw = base64.b64decode(image_base64)
    img = Image.open(io.BytesIO(raw))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img)


def encode_image_base64(image_rgb: np.ndarray, fmt: str = "PNG") -> str:
    """RGB uint8 -> base64 string (util/utils.py:478-481).

    PNG goes through cv2's encoder at zlib level 1 (the overlay is in the
    latency path; PIL's default level costs more host time for a slightly
    smaller output).  Other formats, and a host without cv2, use PIL."""
    if fmt.upper() == "PNG":
        try:
            import cv2

            ok, enc = cv2.imencode(
                ".png", np.asarray(image_rgb)[..., ::-1],
                [cv2.IMWRITE_PNG_COMPRESSION, 1])
            if ok:
                return base64.b64encode(enc.tobytes()).decode("ascii")
        except ImportError:
            pass
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image_rgb).save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def load_image_rgb(path: str) -> np.ndarray:
    """An image file -> RGB uint8 [H, W, 3]."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img)
