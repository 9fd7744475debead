"""Point-cloud I/O: PCD (ASCII + binary) and KITTI velodyne .bin loaders.

Host-side numpy equivalents of the reference's PCL I/O (align.cpp:22-27,
kitti.cpp:40-64, kitti.py:28-31).  Only x/y/z are returned; extra fields are
parsed and dropped.
"""

from __future__ import annotations

import numpy as np

_PCD_TYPE = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
             ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def load_pcd(path: str) -> np.ndarray:
    """Load a .pcd file; returns (N, 3) float32 xyz."""
    with open(path, "rb") as f:
        header = {}
        while True:
            raw_line = f.readline()
            if not raw_line:  # EOF before DATA -> truncated/non-PCD file
                raise ValueError(f"truncated or invalid PCD header: {path}")
            line = raw_line.decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key] = rest.split()
            if key == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n_points = int(header["POINTS"][0])
        data_kind = header["DATA"][0]

        dtype_fields = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            base = _PCD_TYPE[(typ, size)]
            if cnt == 1:
                dtype_fields.append((name, base))
            else:
                dtype_fields.append((name, base, (cnt,)))
        dtype = np.dtype(dtype_fields)

        if data_kind == "binary":
            raw = np.frombuffer(f.read(n_points * dtype.itemsize), dtype=dtype)
        elif data_kind == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n_points, ndmin=2)
            # column offset of each field = prefix sum of COUNTs (a COUNT>1
            # field before x/y/z shifts the coordinate columns)
            col = np.concatenate([[0], np.cumsum(counts)])
            cols = [int(col[fields.index(a)]) for a in ("x", "y", "z")]
            return np.ascontiguousarray(raw[:, cols], dtype=np.float32)
        else:
            raise ValueError(f"unsupported PCD DATA kind: {data_kind}")

    xyz = np.stack([raw["x"], raw["y"], raw["z"]], axis=1)
    return np.ascontiguousarray(xyz, dtype=np.float32)


def save_pcd(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Write (N, 3) xyz to a .pcd file (the PCL-side output path the
    reference gets for free from pcl::io; binary or ASCII)."""
    pts = np.ascontiguousarray(np.asarray(points)[:, :3], dtype=np.float32)
    n = len(pts)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(pts.tobytes())
        else:
            np.savetxt(f, pts, fmt="%.9g")


def load_kitti_bin(path: str, with_channels: bool = False):
    """KITTI velodyne scan: float32 (x, y, z, intensity) records
    (kitti.cpp:40-64); returns (N, 3) float32 xyz, or
    (xyz (N, 3), channels (N, 1) intensity) with with_channels=True —
    the payload the reference's PointXYZI instantiation carries
    (fast_gicp.cpp:1-6)."""
    data = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    xyz = np.ascontiguousarray(data[:, :3])
    if with_channels:
        return xyz, np.ascontiguousarray(data[:, 3:4])
    return xyz


def strip_near_origin(points: np.ndarray, min_sq_norm: float = 1e-3,
                      channels: np.ndarray = None):
    """Drop points with ||p||^2 < min_sq_norm (align.cpp:139-147); slices
    any per-point channel payload consistently."""
    keep = np.einsum("ij,ij->i", points, points) >= min_sq_norm
    if channels is not None:
        return points[keep], channels[keep]
    return points[keep]


def load_relative_txt(path: str) -> np.ndarray:
    """Ground-truth 4x4 pose (data/relative.txt, gicp_test.cpp:55-71)."""
    return np.loadtxt(path).reshape(4, 4).astype(np.float64)
