"""CXR image decode + MedFuse-style transforms (host-side, PIL).

Counterpart of ``multimodalrouting_tpu/data/images.py``, copied with the port's
imports; its outputs equal the JAX package's bit for bit (tests/test_torch_data*.py).

The reference decodes one JPEG/DICOM per stay inside the DataLoader workers
and applies torchvision transforms (reference: MIMIC-IV/MortModel/
Paired_Cross_Attention/main.py:907-925 ``build_image_transform`` and
:1487-1521 ``load_cxr_tensor``; MedFuse_Preprocessing/datasets/
cxr_dataset.py:64-86 ``get_transforms``). This module re-implements both
transform stacks with PIL + numpy — torchvision is not a dependency — with
the same op semantics:

  * ``Grayscale(num_output_channels=3)``  -> PIL convert("L") replicated x3
  * ``Resize(256)``                        -> shorter side to 256, bilinear
  * ``RandomHorizontalFlip(0.5)``
  * ``RandomAffine(...)``                  -> torchvision's exact inverse
    affine matrix (rotation/translate/scale/shear about the image center)
    applied with nearest interpolation (torchvision's RandomAffine default)
  * ``RandomCrop(224)`` / ``CenterCrop(224)``
  * ``ToTensor + Normalize(IMAGENET)``     -> float32 /255, (x-mean)/std

Outputs are **NHWC** float32 (the layout models/cxr.py takes),
not torchvision's CHW. Decode failures return ``None`` so the dataset layer
can record the image as absent (the reference substitutes a zero tensor and
keeps claiming presence — we deliberately do not: see data/loader.py has_i).
DICOM decode is gated on pydicom availability like the reference's lazy
import (main.py:1498-1503).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# torchvision column-standardization candidates (reference main.py:926-935)
PATH_COLUMN_CANDIDATES = (
    "cxr_path", "CXR_PATH", "image_path", "img_path", "path",
    "dicom_path", "png_path", "jpg_path",
)


def find_image_path_column(columns: Sequence[str]) -> Optional[str]:
    """First reference-recognized image path column present, else None
    (reference: main.py:926-948 _standardize_image_path_column)."""
    for c in PATH_COLUMN_CANDIDATES:
        if c in columns:
            return c
    return None


# ---------------------------------------------------------------------------
# torchvision-semantics building blocks (PIL)
# ---------------------------------------------------------------------------


def _resize_shorter(img, size: int):
    """torchvision Resize(int): shorter side -> size, aspect preserved."""
    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        ow, oh = size, max(int(round(size * h / w)), 1)
    else:
        ow, oh = max(int(round(size * w / h)), 1), size
    from PIL import Image

    return img.resize((ow, oh), Image.BILINEAR)


def _center_crop(img, th: int, tw: int):
    from PIL import ImageOps

    w, h = img.size
    if w < tw or h < th:  # torchvision pads with 0 when smaller than crop
        img = ImageOps.expand(
            img,
            border=(
                max((tw - w) // 2, 0), max((th - h) // 2, 0),
                max(tw - w - max((tw - w) // 2, 0), 0),
                max(th - h - max((th - h) // 2, 0), 0),
            ),
            fill=0,
        )
        w, h = img.size
    left = int(round((w - tw) / 2.0))
    top = int(round((h - th) / 2.0))
    return img.crop((left, top, left + tw, top + th))


def _random_crop(img, th: int, tw: int, rng: np.random.Generator):
    w, h = img.size
    if w < tw or h < th:
        img = _center_crop(img, max(th, h), max(tw, w))
        w, h = img.size
    top = int(rng.integers(0, h - th + 1))
    left = int(rng.integers(0, w - tw + 1))
    return img.crop((left, top, left + tw, top + th))


def inverse_affine_matrix(
    center: Tuple[float, float],
    angle: float,
    translate: Tuple[float, float],
    scale: float,
    shear: Tuple[float, float],
) -> List[float]:
    """torchvision.transforms.functional._get_inverse_affine_matrix, verbatim
    math: the inverse of T(translate) C(center) R(angle) S(scale) Sh(shear)
    C^-1, as the 6-tuple PIL's Image.AFFINE expects."""
    rot = math.radians(angle)
    sx = math.radians(shear[0])
    sy = math.radians(shear[1])
    cx, cy = center
    tx, ty = translate

    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)

    matrix = [d, -b, 0.0, -c, a, 0.0]
    matrix = [m / scale for m in matrix]
    matrix[2] += matrix[0] * (-cx - tx) + matrix[1] * (-cy - ty)
    matrix[5] += matrix[3] * (-cx - tx) + matrix[4] * (-cy - ty)
    matrix[2] += cx
    matrix[5] += cy
    return matrix


def _random_affine(
    img,
    rng: np.random.Generator,
    degrees: float,
    translate: Tuple[float, float],
    scale: Tuple[float, float],
    shear: float,
):
    """torchvision RandomAffine.get_params sampling + PIL affine apply
    (nearest interpolation, zero fill — torchvision defaults)."""
    from PIL import Image

    w, h = img.size
    angle = float(rng.uniform(-degrees, degrees))
    max_dx, max_dy = translate[0] * w, translate[1] * h
    tx = int(round(float(rng.uniform(-max_dx, max_dx))))
    ty = int(round(float(rng.uniform(-max_dy, max_dy))))
    sc = float(rng.uniform(scale[0], scale[1]))
    sh = float(rng.uniform(-shear, shear)) if shear else 0.0
    matrix = inverse_affine_matrix((w * 0.5, h * 0.5), angle, (tx, ty), sc, (sh, 0.0))
    return img.transform((w, h), Image.AFFINE, matrix, resample=Image.NEAREST, fillcolor=0)


def to_normalized_array(img) -> np.ndarray:
    """ToTensor + Normalize(IMAGENET), emitted as HWC float32."""
    arr = np.asarray(img, dtype=np.float32) / np.float32(255.0)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    arr = (arr - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)
    return np.ascontiguousarray(arr, dtype=np.float32)


def to_uint8_array(img) -> np.ndarray:
    """Post-geometry pixels as HWC uint8 (the device-normalize path: the
    model applies /255 + IMAGENET normalize on the device — models/cxr.py
    normalize_pixels — so the host ships 4x fewer bytes per image)."""
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    return np.ascontiguousarray(arr, dtype=np.uint8)


# ---------------------------------------------------------------------------
# Transform stacks
# ---------------------------------------------------------------------------


@dataclass
class ImageTransform:
    """One of the reference's two transform stacks, train or eval mode.

    spec="flagship": Grayscale(3) first, RandomAffine(10, .05, (.95,1.05),
    shear 5) + RandomCrop on train (main.py:907-925).
    spec="medfuse": no grayscale, RandomAffine(45, .15, (.85,1.15), shear 0)
    + CenterCrop on train (cxr_dataset.py:64-86).
    """

    split: str = "eval"  # train | eval
    spec: str = "flagship"  # flagship | medfuse
    resize: int = 256
    crop: int = 224
    seed: int = 0
    pixels: str = "normalized"  # normalized (fp32 host-side Normalize) |
    # uint8 (geometry only; /255 + Normalize run on the device in the
    # model — encoder.image_uint8_transfer)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def reseed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    def __call__(self, img) -> np.ndarray:
        img = img.convert("RGB")
        if self.spec == "flagship":
            img = img.convert("L").convert("RGB")  # Grayscale(num_output_channels=3)
        img = _resize_shorter(img, self.resize)
        if self.split == "train":
            if self._rng.random() < 0.5:
                from PIL import ImageOps

                img = ImageOps.mirror(img)
            if self.spec == "flagship":
                img = _random_affine(
                    img, self._rng, degrees=10.0, translate=(0.05, 0.05),
                    scale=(0.95, 1.05), shear=5.0,
                )
                img = _random_crop(img, self.crop, self.crop, self._rng)
            else:
                img = _random_affine(
                    img, self._rng, degrees=45.0, translate=(0.15, 0.15),
                    scale=(0.85, 1.15), shear=0.0,
                )
                img = _center_crop(img, self.crop, self.crop)
        else:
            img = _center_crop(img, self.crop, self.crop)
        if self.pixels == "uint8":
            return to_uint8_array(img)
        return to_normalized_array(img)


def build_image_transform(
    split: str,
    *,
    spec: str = "flagship",
    resize: int = 256,
    crop: int = 224,
    seed: int = 0,
    pixels: str = "normalized",
) -> ImageTransform:
    """Reference build_image_transform(split) equivalent (main.py:907-925)."""
    mode = "train" if str(split).lower() == "train" else "eval"
    return ImageTransform(
        split=mode, spec=spec, resize=resize, crop=crop, seed=seed, pixels=pixels
    )


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_image(path: str) -> Optional["object"]:
    """Decode a JPEG/PNG (PIL) or DICOM (pydicom, if installed) to a PIL
    image; None on any failure (reference load_cxr_tensor's zero-tensor
    fallback, main.py:1487-1521 — here the caller records absence instead)."""
    p = str(path).strip()
    if not p or not os.path.exists(p):
        return None
    try:
        if os.path.splitext(p.lower())[1] == ".dcm":
            try:
                import pydicom  # optional, like the reference's lazy import
            except ImportError:
                return None
            ds = pydicom.dcmread(p)
            arr = ds.pixel_array.astype(np.float32)
            arr = arr - arr.min()
            if arr.max() > 0:
                arr = arr / arr.max()
            arr = (arr * 255.0).clip(0, 255).astype(np.uint8)
            from PIL import Image

            return Image.fromarray(arr)
        from PIL import Image

        img = Image.open(p)
        img.load()
        return img
    except Exception:
        return None


def make_image_loader(
    split: str,
    *,
    spec: str = "flagship",
    resize: int = 256,
    crop: int = 224,
    seed: int = 0,
    root: str = "",
    pixels: str = "normalized",
) -> Callable[[object], Optional[np.ndarray]]:
    """Row-level loader for data/loader.load_split: images-parquet row ->
    [crop, crop, 3] array (float32 normalized, or uint8 when
    pixels="uint8" for on-device normalization), or None when the row has
    no decodable image. Reads the first reference-recognized path column."""
    tfm = build_image_transform(
        split, spec=spec, resize=resize, crop=crop, seed=seed, pixels=pixels
    )

    def load(row) -> Optional[np.ndarray]:
        col = find_image_path_column(getattr(row, "index", []))
        if col is None:
            return None
        path = row[col]
        if path is None or (isinstance(path, float) and np.isnan(path)):
            return None
        p = str(path)
        if root and not os.path.isabs(p):
            p = os.path.join(root, p)
        img = decode_image(p)
        if img is None:
            return None
        return tfm(img)

    return load
