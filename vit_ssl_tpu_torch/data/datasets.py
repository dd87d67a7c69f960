"""Datasets (from ``vit_ssl_tpu/data/datasets.py``): the base ``Dataset``, the
decoder and its cache, the labeled datasets (``CIFAR10Dataset``,
``STL10Dataset``, ``ImageFolderDataset``), the unlabeled STL-10 folder with
its whole-batch decode (``native_batch``, on :mod:`.native`), DINO's host
multi-crop ``STL10DINODataset`` and ``Subset``.

Datasets return numpy arrays (uint8 HWC after the device-augment pipeline's
decode and resize, float32 after a host ``ToTensor``; a list of views from
the multi-crop) and, when labeled, int labels; the loader stacks them into
NHWC batches.

Decoding chooses the decoder by a file's magic bytes, never by its
extension (an ImageNet file named ``.JPEG`` may hold a PNG): PNG through
:mod:`.png` (the port's C++ decoder), JPEG through :mod:`.jpeg` (the port's
C++ decoder; each built with the host compiler at first use), BMP through
:mod:`.bmp` (numpy), WebP through :mod:`.webp` (the port's C++ decoder) and
TIFF through :mod:`.tiff` (numpy, LZW and PackBits in C++), each bit-equal
to the caller's reference (OpenCV's reader then PIL for the datasets, PIL
for the server), so a folder of these formats needs neither OpenCV nor PIL.
Only what these decoders refuse by name (GIF and other formats,
arithmetic-coded JPEG, animated WebP, CMYK TIFF, ...) goes to OpenCV or PIL
where one is installed; a damaged file raises ``ValueError`` naming it.

The labeled indexes are read as the JAX package's pandas reads them, with
``csv`` and ``json``: the first column is the file, the second the class;
the classes are the sorted distinct values of the second column (numbers
when every value of a CSV column is an integer, as pandas infers them), and
a label is its class's index.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import bmp, jpeg, native, png, tiff, webp


class Dataset:
    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int):
        raise NotImplementedError


# a reference: the JAX package's dataset reader (OpenCV, then PIL) or its
# server's (PIL), and the libraries that read what the port's decoders refuse
_REFERENCES = {"cv2": ("cv2", "PIL"), "pil": ("PIL", "cv2")}


def _own_decoder(data: bytes, reference: str):
    """(format, decode, its refusal) of the port's decoder for ``data``'s
    magic bytes, set to ``reference``, or None."""
    rotate = reference == "cv2"  # OpenCV applies the EXIF orientation, PIL does not
    if png.is_png(data):
        return "PNG", lambda d: png.decode_bytes(d, reference), png.UnsupportedPNG
    if jpeg.is_jpeg(data):
        return ("JPEG", lambda d: jpeg.decode_bytes(d, exif_orientation=rotate, cmyk=reference),
                jpeg.UnsupportedJPEG)
    if bmp.is_bmp(data):
        return "BMP", lambda d: bmp.decode_bytes(d, reference), bmp.UnsupportedBMP
    if webp.is_webp(data):
        return ("WebP", lambda d: webp.decode_bytes(d, exif_orientation=rotate),
                webp.UnsupportedWebP)
    if tiff.is_tiff(data):
        return "TIFF", lambda d: tiff.decode_bytes(d, reference), tiff.UnsupportedTIFF
    return None


def _format_name(data: bytes) -> str:
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "a GIF file"
    return "not a PNG, JPEG, BMP, WebP or TIFF file"


def _decode_with(library: str, path: str):
    """RGB uint8 HWC from OpenCV or PIL, or None where it is not installed
    or (OpenCV) cannot read the file."""
    if library == "cv2":
        try:
            import cv2
        except ImportError:
            return None
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        return None
    with Image.open(path) as pil:
        return np.asarray(pil.convert("RGB"))


def _load_image(path: str, reference: str = "cv2") -> np.ndarray:
    """Decode to RGB uint8 HWC with the port's decoder for the file's magic
    bytes (PNG, JPEG, BMP, WebP, TIFF), bit-equal to ``reference``: "cv2"
    the datasets' ``cv2.imread(..., IMREAD_COLOR)`` then PIL (EXIF
    orientation applied), "pil" the server's ``Image.open(...).convert("RGB")``. What the decoder refuses by
    name, and other formats, go to OpenCV or PIL where one is installed;
    without them, and for a damaged file, ``ValueError`` names the file."""
    libraries = _REFERENCES[reference]
    with open(path, "rb") as f:
        data = f.read()
    own, refused = _own_decoder(data, reference), None
    if own is not None:
        kind, decode, unsupported = own
        try:
            return decode(data)
        except unsupported as e:
            refused = e
        except ValueError as e:
            raise ValueError(f"{path}: damaged {kind} file: {e}") from e
    for library in libraries:
        image = _decode_with(library, path)
        if image is not None:
            return image
    raise ValueError(
        f"{path}: {refused or _format_name(data)}; without OpenCV or PIL installed "
        "only PNG, JPEG, BMP, WebP and TIFF images decode (ROADMAP.md: GIF and other "
        "formats)")


class _DecodeCache:
    """Optional in-memory decoded-sample cache (``data.cache_decoded``).

    When the dataset's pipeline is deterministic (the device-augment
    contract: decode and resize), the post-transform sample is cached, so
    later epochs pay neither decode nor resize; a random pipeline caches
    the raw decode."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._store: Dict[str, np.ndarray] = {}

    def load(self, path: str) -> np.ndarray:
        if not self.enabled:
            return _load_image(path)
        hit = self._store.get(path)
        if hit is None:
            hit = _load_image(path)
            self._store[path] = hit
        return hit

    def load_transformed(self, path: str, transform, rng):
        """Decode + transform with the sample cached at the latest
        deterministic stage."""
        if not self.enabled:
            image = _load_image(path)
            return transform(image, rng) if transform else image
        from .transforms import is_deterministic

        if transform is None or not is_deterministic(transform):
            image = self.load(path)
            return transform(image, rng) if transform else image
        hit = self._store.get(path)
        if hit is None:
            hit = transform(_load_image(path), rng)
            self._store[path] = hit
        return hit


def _csv_value(text: str):
    """A CSV cell as pandas would type it in a column of integers."""
    try:
        return int(text)
    except ValueError:
        return text


def _read_csv_rows(path: str) -> List[Tuple]:
    """The rows under the header of a CSV file; a column whose every value
    is an integer holds ints (pandas' inference), other columns strings."""
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f)][1:]
    rows = [row for row in rows if row]
    columns = list(zip(*rows)) if rows else []
    typed = []
    for col in columns:
        values = [_csv_value(v) for v in col]
        typed.append(values if all(isinstance(v, int) for v in values) else list(col))
    return list(zip(*typed))


def _read_json_rows(path: str) -> List[Tuple]:
    """The records of a JSON index: a list of [file, class] lists, or of
    objects whose first two values are those (pandas' ``read_json``)."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, list):
        raise ValueError(f"{path}: expected a JSON list of records")
    return [tuple(rec.values()) if isinstance(rec, dict) else tuple(rec)
            for rec in data]


class _IndexedDataset(Dataset):
    """A folder of images indexed by (file, class) rows."""

    def __init__(self, rows: Sequence[Tuple], root_dir: str,
                 transform: Optional[Callable] = None, cache: bool = False):
        self.rows = list(rows)
        self.root_dir = root_dir
        self.transform = transform
        self._cache = _DecodeCache(cache)
        self.classes = sorted({row[1] for row in self.rows})
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}

    def __len__(self):
        return len(self.rows)

    def _path(self, name) -> str:
        raise NotImplementedError

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        name, cls = self.rows[idx][0], self.rows[idx][1]
        image = self._cache.load_transformed(self._path(name), self.transform, rng)
        return image, self.class_to_idx[cls]


class CIFAR10Dataset(_IndexedDataset):
    """CSV-indexed PNG folder: column 0 is the file stem, column 1 the class
    name."""

    def __init__(self, csv_file: str, root_dir: str,
                 transform: Optional[Callable] = None, cache: bool = False):
        super().__init__(_read_csv_rows(csv_file), root_dir, transform, cache)

    def _path(self, name) -> str:
        return os.path.join(self.root_dir, f"{name}.png")


class STL10Dataset(_IndexedDataset):
    """JSON-indexed labeled folder: each record's file (its last path
    component under ``root_dir``) and class."""

    def __init__(self, json_file: str, root_dir: str,
                 transform: Optional[Callable] = None, cache: bool = False):
        super().__init__(_read_json_rows(json_file), root_dir, transform, cache)

    def _path(self, name) -> str:
        return os.path.join(self.root_dir, str(name).split("/")[-1])


class ImageFolderDataset(Dataset):
    """Class-per-subdirectory layout (ImageNet-style), labeled:
    ``<root>/<class_name>/*.{png,jpg,jpeg,bmp,webp}``."""

    EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

    def __init__(self, root_dir: str, transform: Optional[Callable] = None):
        self.root_dir = root_dir
        self.transform = transform
        self.classes = sorted(d for d in os.listdir(root_dir)
                              if os.path.isdir(os.path.join(root_dir, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for cls in self.classes:
            cls_dir = os.path.join(root_dir, cls)
            for name in sorted(os.listdir(cls_dir)):
                if name.lower().endswith(self.EXTENSIONS):
                    self.samples.append((os.path.join(cls_dir, name),
                                         self.class_to_idx[cls]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        path, label = self.samples[idx]
        image = _load_image(path)
        if self.transform:
            image = self.transform(image, rng)
        return image, label


class STL10UnsupervisedDataset(Dataset):
    """Sorted glob of ``*.png``, image-only."""

    def __init__(self, root_dir: str, transform: Optional[Callable] = None,
                 cache: bool = False, native_decode: bool = False):
        self.root_dir = root_dir
        self.transform = transform
        self.files = sorted(glob.glob(f"{root_dir}/*.png"))
        self._cache = _DecodeCache(cache)
        self.native_decode = native_decode

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        return self._cache.load_transformed(self.files[idx], self.transform, rng)

    def _native_size(self):
        """(h, w) when the pipeline is decode+Resize only (the device-
        augment contract), else None: gates the whole-batch path."""
        from .transforms import Compose, Resize

        t = self.transform
        if isinstance(t, Compose) and len(t.transforms) == 1:
            t = t.transforms[0]
        if isinstance(t, Resize) and isinstance(t.size, (list, tuple)):
            return int(t.size[0]), int(t.size[1])
        return None

    def native_batch(self, indices):
        """Decode and resize a whole batch in one call of the host library
        (:func:`.native.decode_batch`, the counterpart of the JAX package's
        ``csrc/fastloader.cpp``; the same decoders and resize as the
        per-sample path, so the samples are the same). Returns a list of
        uint8 HWC arrays, or None to use the per-sample path:
        ``data.native_decode`` off, the cache on (it is faster than either
        after epoch 1), a pipeline other than decode and Resize, or a file
        the call did not decode (the per-sample path decodes it or names
        it)."""
        if not self.native_decode or self._cache.enabled:
            return None
        size = self._native_size()
        if size is None:
            return None
        out, ok = native.decode_batch([self.files[int(i)] for i in indices], *size)
        if not ok.all():
            return None
        return list(out)


class STL10DINODataset(Dataset):
    """DINO's host multi-crop: a sorted glob of ``*.png``; each item is one
    decode, then ``num_global_views`` draws of ``transforms["globals"]``
    and ``num_all_views - num_global_views`` of ``transforms["locals"]``,
    all from the item's generator, globals first."""

    def __init__(self, root_dir: str, transforms: Optional[Dict[str, Callable]] = None,
                 num_all_views: Optional[int] = None,
                 num_global_views: Optional[int] = None):
        self.root_dir = root_dir
        self.transforms = transforms
        self.files = sorted(glob.glob(f"{root_dir}/*.png"))
        self.num_all_views = num_all_views
        self._num_global_views = num_global_views
        self._cache = _DecodeCache(False)

    @property
    def num_global_views(self) -> int:
        return self._num_global_views

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None) -> List[np.ndarray]:
        arr = self._cache.load(self.files[idx])
        views = [self.transforms["globals"](arr, rng)
                 for _ in range(self.num_global_views)]
        num_local = self.num_all_views - self.num_global_views
        views.extend(self.transforms["locals"](arr, rng) for _ in range(num_local))
        return views


class Subset(Dataset):
    """Index-restricted view of a dataset (the seeded train/val split)."""

    def __init__(self, dataset: Dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)
        if hasattr(dataset, "num_global_views"):
            self.num_global_views = dataset.num_global_views
        if hasattr(dataset, "classes"):
            self.classes = dataset.classes

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        return self.dataset.__getitem__(self.indices[idx], rng)

    def native_batch(self, indices):
        inner = getattr(self.dataset, "native_batch", None)
        if inner is None:
            return None
        return inner([self.indices[int(i)] for i in indices])
