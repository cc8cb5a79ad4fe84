"""MetaImage (.mha / .mhd) I/O in NumPy and zlib.

Port of dram_tpu/data/io.py (`_parse_header` :41, `read_mha` :62,
`write_mha` :121, `resample_mha_file` :181, `write_array_to_mha_itk`
:203): a header parser and zlib (de)compression, no SimpleITK.
Conventions, as dram_tpu's (the way the reference uses SimpleITK):
* `read_mha` returns the array in (z, y, x) index order, the layout
  sitk.GetArrayFromImage produces, with spacing and origin in (z, y, x)
  order and the direction matrix flattened in (z, y, x) row order;
* `write_mha` takes (z, y, x) arrays and z-y-x spacing and origin, and
  writes the same bytes as dram_tpu's for the same array and header.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

_MET_TO_DTYPE = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_LONG_LONG": np.int64,
    "MET_ULONG_LONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_DTYPE_TO_MET = {np.dtype(v): k for k, v in _MET_TO_DTYPE.items()}


def _parse_header(fp):
    """Read 'Key = Value' lines until ElementDataFile; return dict + offset."""
    header = {}
    while True:
        line = b""
        while not line.endswith(b"\n"):
            ch = fp.read(1)
            if not ch:
                raise ValueError("unexpected EOF in MHA header")
            line += ch
        text = line.decode("ascii", errors="replace").strip()
        if not text:
            continue
        key, _, value = text.partition("=")
        key = key.strip()
        header[key] = value.strip()
        if key == "ElementDataFile":
            break
    return header


def read_mha(path):
    """Read a MetaImage file -> dict with keys:

    array      np.ndarray in (z, y, x) order
    spacing    (z, y, x) float tuple
    origin     (z, y, x) float tuple
    direction  length-9 list, (z, y, x)-row-order flattened 3x3

    Accepts both common ITK layouts the reference's SimpleITK reader
    (reference utils.py:142-159, dataset.py:50-57) handles silently:
    single-file `.mha` (ElementDataFile = LOCAL) and `.mhd` headers whose
    ElementDataFile names an external `.raw`/`.zraw` file (resolved
    relative to the header's directory). LIST / printf-pattern slice
    layouts remain unsupported.
    """
    with open(path, "rb") as fp:
        header = _parse_header(fp)
        edf = header.get("ElementDataFile", "LOCAL")
        if edf.upper() == "LOCAL":
            raw = fp.read()
        elif edf.upper() == "LIST" or "%" in edf:
            raise NotImplementedError(
                "LIST / pattern ElementDataFile layouts not supported")
        else:
            data_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                                     edf)
            with open(data_path, "rb") as dfp:
                raw = dfp.read()

    ndims = int(header.get("NDims", 3))
    dims = [int(v) for v in header["DimSize"].split()]  # x y z
    dtype = np.dtype(_MET_TO_DTYPE[header["ElementType"]])
    if header.get("BinaryDataByteOrderMSB", "False").lower() == "true":
        dtype = dtype.newbyteorder(">")
    n_channels = int(header.get("ElementNumberOfChannels", 1))

    if header.get("CompressedData", "False").lower() == "true":
        raw = zlib.decompress(raw)
    count = int(np.prod(dims)) * n_channels
    arr = np.frombuffer(raw, dtype=dtype, count=count)
    shape = dims[::-1] + ([n_channels] if n_channels > 1 else [])
    arr = arr.reshape(shape)
    arr = np.ascontiguousarray(arr.astype(dtype.newbyteorder("=")))

    spacing = [float(v) for v in
               header.get("ElementSpacing", " ".join(["1"] * ndims)).split()]
    origin = [float(v) for v in
              header.get("Offset", " ".join(["0"] * ndims)).split()]
    tm = header.get("TransformMatrix", "1 0 0 0 1 0 0 0 1")
    direction_xyz = np.array([float(v) for v in tm.split()],
                             np.float64).reshape(ndims, ndims)
    direction_zyx = direction_xyz[::-1].flatten().tolist()

    return {
        "array": arr,
        "spacing": tuple(spacing[::-1]),
        "origin": tuple(origin[::-1]),
        "direction": direction_zyx,
        "header": header,
    }


def write_mha(path, array, spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0),
              direction=None, compress=True):
    """Write a (z, y, x) array to MetaImage. spacing/origin are z-y-x
    ordered; direction is a length-9 z-y-x-row-order list (or None for
    identity). A `.mhd` path writes the two-file header + external
    `.raw`/`.zraw` layout; anything else writes single-file LOCAL data."""
    array = np.asarray(array)
    array = np.ascontiguousarray(array)
    if array.dtype == np.bool_:
        array = array.astype(np.uint8)
    met_type = _DTYPE_TO_MET.get(array.dtype)
    if met_type is None:
        raise TypeError(f"unsupported dtype {array.dtype} for MHA")
    ndims = array.ndim
    dims_xyz = list(array.shape[::-1])
    spacing_xyz = list(spacing[::-1])
    origin_xyz = list(origin[::-1])
    if direction is None:
        dir_xyz = np.eye(ndims, dtype=np.float64)
    else:
        dir_xyz = np.asarray(direction, np.float64).reshape(ndims, ndims)[::-1]

    payload = array.tobytes()
    lines = [
        "ObjectType = Image",
        f"NDims = {ndims}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
    ]
    if compress:
        payload = zlib.compress(payload)
        lines.append("CompressedData = True")
        lines.append(f"CompressedDataSize = {len(payload)}")
    else:
        lines.append("CompressedData = False")
    two_file = os.path.splitext(path)[1].lower() == ".mhd"
    if two_file:
        data_name = os.path.basename(os.path.splitext(path)[0]) + \
            (".zraw" if compress else ".raw")
    lines += [
        "TransformMatrix = " + " ".join(f"{v:g}" for v in dir_xyz.flatten()),
        "Offset = " + " ".join(f"{v:g}" for v in origin_xyz),
        "CenterOfRotation = " + " ".join(["0"] * ndims),
        "ElementSpacing = " + " ".join(f"{v:g}" for v in spacing_xyz),
        f"DimSize = " + " ".join(str(v) for v in dims_xyz),
        f"ElementType = {met_type}",
        "ElementDataFile = " + (data_name if two_file else "LOCAL"),
    ]
    header = ("\n".join(lines) + "\n").encode("ascii")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fp:
        fp.write(header)
        if not two_file:
            fp.write(payload)
    if two_file:
        with open(os.path.join(os.path.dirname(os.path.abspath(path)),
                               data_name), "wb") as fp:
            fp.write(payload)


def resample_mha_file(input_filename, output_filename, factor=2,
                      interpolator="linear"):
    """File -> file resample by a spacing factor (factor > 1
    downsamples): the grid is ceil(size / factor), the interpolator any
    name of core.resample.ITK_METHODS, on the NumPy separable path in
    float32; an input other than float32 is rounded half to even and
    cast back to its dtype (no clip). Origin and direction are kept.
    Returns `output_filename`."""
    from ..core.resample import itk_resample3d_np
    d = read_mha(input_filename)
    spacing = np.asarray(d["spacing"], np.float64)
    new_spacing = spacing * factor
    scales = new_spacing / spacing
    out_size = tuple(int(np.ceil(s / sc))
                     for s, sc in zip(d["array"].shape, scales))
    arr = itk_resample3d_np(d["array"].astype(np.float32), out_size,
                            scales=scales.tolist(), method=interpolator,
                            fill_value=0.0)
    if d["array"].dtype != np.float32:
        arr = np.round(arr).astype(d["array"].dtype)
    write_mha(output_filename, arr, spacing=tuple(new_spacing),
              origin=d["origin"], direction=d["direction"])
    return output_filename


def write_array_to_mha_itk(target_path, arrs, names, type=np.int16,
                           origin=(0.0, 0.0, 0.0),
                           direction=None,
                           spacing=(1.0, 1.0, 1.0)):
    """Reference-compatible batch writer (utils.py:142-159 contract):
    arrays and spacing/origin/direction are given in z-y-x order already
    reversed by the caller — here everything is natively z-y-x, so the
    caller passes them straight through."""
    for arr, name in zip(arrs, names):
        write_mha(os.path.join(target_path, f"{name}.mha"), arr.astype(type),
                  spacing=spacing, origin=origin, direction=direction,
                  compress=True)
