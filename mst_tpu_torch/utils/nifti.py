"""NIfTI-1 writer (numpy and gzip only).

Counterpart of `mst_tpu/utils/nifti.py` `write_nifti`, for the saliency and
input volumes of `python -m mst_tpu_torch.predict --save_saliency`: a
single `.nii` / `.nii.gz` file, scalar dtypes, the affine in the sform rows
and the voxel sizes in pixdim. (`mst_tpu.utils` cannot be imported here:
importing `mst_tpu` imports JAX.)
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Optional

import numpy as np

# NIfTI-1 datatype codes
_CODES = {np.dtype(t): c for c, t in (
    (2, np.uint8), (4, np.int16), (8, np.int32), (16, np.float32),
    (64, np.float64), (256, np.int8), (512, np.uint16), (768, np.uint32),
    (1024, np.int64), (1280, np.uint64))}


def write_nifti(path, data: np.ndarray, affine: Optional[np.ndarray] = None):
    """Write `data` [x, y, z, ...] as a NIfTI-1 single file (gzip-compressed
    when `path` ends in .gz). Booleans go as uint8, other dtypes without a
    code as float32; `affine` defaults to the identity."""
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    affine = np.eye(4) if affine is None else np.asarray(affine, np.float64)

    dim = [data.ndim, *data.shape] + [1] * (7 - data.ndim)
    pixdim = [1.0] + [float(np.linalg.norm(affine[:3, i])) for i in range(3)]
    pixdim += [1.0] * 4
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)  # sizeof_hdr
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[data.dtype])  # datatype
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope, scl_inter
    struct.pack_into("<h", hdr, 252, 1)  # qform_code (identity quaternion)
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<12f", hdr, 280, *affine[:3].ravel())
    hdr[344:348] = b"n+1\x00"

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(data.tobytes(order="F"))
