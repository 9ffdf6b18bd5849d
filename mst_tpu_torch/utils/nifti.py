"""NIfTI-1 reader and writer (numpy and gzip only).

Counterpart of `mst_tpu/utils/nifti.py`. `read_nifti` is the plain version
of the native reader (`data/native_io.py`): single-file NIfTI-1 (.nii /
.nii.gz), scalar dtypes, the affine from the sform rows (else the pixdim
diagonal, as the LIDC preprocessing writes it) and scl_slope / scl_inter
scaling. `write_nifti` writes the saliency and input volumes of
`python -m mst_tpu_torch.predict --save_saliency` and the tests' files:
the affine it is given in the sform rows, the voxel sizes in pixdim.
(`mst_tpu.utils` cannot be imported here: importing `mst_tpu` imports
JAX.)
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

# NIfTI-1 datatype codes
_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
           64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
           1024: np.int64, 1280: np.uint64}
_CODES = {np.dtype(t): c for c, t in _DTYPES.items()}


def _open(path, mode="rb"):
    return gzip.open(path, mode) if str(path).endswith(".gz") else open(
        path, mode)


def read_nifti(path) -> Tuple[np.ndarray, np.ndarray]:
    """-> (data [x, y, z, ...] as stored, affine [4, 4] f64)."""
    with _open(path) as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        endian = "<"
        if struct.unpack("<i", hdr[0:4])[0] != 348:
            endian = ">"
            if struct.unpack(">i", hdr[0:4])[0] != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
        if hdr[344:346] not in (b"n+", b"ni"):
            raise ValueError(f"{path}: bad NIfTI magic {hdr[344:348]!r}")
        dim = struct.unpack(endian + "8h", hdr[40:56])
        shape = tuple(int(d) for d in dim[1:1 + dim[0]])
        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
        pixdim = struct.unpack(endian + "8f", hdr[76:108])
        vox_offset = int(struct.unpack(endian + "f", hdr[108:112])[0])
        scl_slope, scl_inter = struct.unpack(endian + "2f", hdr[112:120])
        sform_code = struct.unpack(endian + "h", hdr[254:256])[0]
        srow = np.array(struct.unpack(endian + "12f", hdr[280:328])
                        ).reshape(3, 4)
        f.read(max(vox_offset - 348, 0))
        data = np.frombuffer(f.read(int(np.prod(shape)) * dtype.itemsize),
                             dtype=dtype).reshape(shape, order="F")
    affine = np.eye(4)
    if sform_code > 0:
        affine[:3] = srow
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1:4]
    # NaN slope / inter mean "no scaling" (nibabel's rule)
    slope = scl_slope if np.isfinite(scl_slope) and scl_slope != 0.0 else 1.0
    inter = scl_inter if np.isfinite(scl_inter) else 0.0
    if slope != 1.0 or inter != 0.0:
        data = data.astype(np.float32) * slope + inter
    return np.asarray(data), affine


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
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(data.tobytes(order="F"))
