"""Minimal PLY reader (binary_little_endian and ascii) and writer
(binary_little_endian), pure numpy: the port's own copy of
`contextgs_tpu/scene/ply_io.py`.

Reads and writes a single 'vertex' element with named scalar properties,
which is all the pipeline needs (point clouds and anchor snapshots); the
writer writes what the JAX package's writes, byte for byte.
"""

from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}
_INV_DTYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i1": "char",
               "i2": "short", "u2": "ushort", "i4": "int", "u4": "uint"}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the 'vertex' element → dict of property name → [N] array."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("comment"):
                continue
            elif line.startswith("element"):
                _, name, count = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_vertex = int(count)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list properties unsupported in vertex element")
                props.append((parts[2], _PLY_DTYPES[parts[1]]))
            elif line == "end_header":
                break
        dtype = np.dtype([(n, t) for n, t in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype,
                                 count=n_vertex)
        elif fmt == "ascii":
            rows = [f.readline().split() for _ in range(n_vertex)]
            data = np.array([tuple(r[: len(props)]) for r in rows], dtype=dtype)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
        return {name: np.ascontiguousarray(data[name]) for name, _ in props}


def write_ply(path: str, fields: dict[str, np.ndarray]) -> None:
    """Write dict of property name → [N] array as a binary_little_endian PLY."""
    names = list(fields)
    n = len(fields[names[0]])
    cols = {k: np.asarray(v).reshape(n) for k, v in fields.items()}
    dtype = np.dtype([(k, cols[k].dtype.str.lstrip("<>|=")) for k in names])
    rec = np.empty(n, dtype=dtype)
    for k in names:
        rec[k] = cols[k]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for k in names:
            f.write(f"property {_INV_DTYPES[rec.dtype[k].str.lstrip('<>|=')]} {k}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def read_point_cloud(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read xyz/rgb/normals point cloud (ref fetchPly, dataset_readers.py:115-123)."""
    v = read_ply(path)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    if "red" in v:
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1) / 255.0
    else:
        rgb = np.random.rand(len(xyz), 3)
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1)
    else:
        normals = np.zeros_like(xyz)
    return xyz, rgb, normals


def write_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write xyz + rgb(0..255) + zero normals (ref storePly, dataset_readers.py:125-141)."""
    n = len(xyz)
    z = np.zeros(n, dtype=np.float32)
    fields = {
        "x": xyz[:, 0].astype(np.float32), "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "nx": z, "ny": z, "nz": z,
        "red": rgb[:, 0].astype(np.uint8), "green": rgb[:, 1].astype(np.uint8),
        "blue": rgb[:, 2].astype(np.uint8),
    }
    write_ply(path, fields)
