"""PLY mesh loader (ASCII + binary_little_endian), NumPy-vectorized
(counterpart of `fluctus_tpu/scene/loaders/ply.py`, the same arrays bit
for bit; a binary list element whose rows all have one length is read in
one strided view instead of row by row).

Capability parity with the reference's custom PLY reader
(reference: src/scene.cpp:422-553): arbitrary named vertex properties with
x/y/z and optional nx/ny/nz extracted by name, tri and quad faces (quads split
fan-wise), normals indexed like their vertices. Vectorized instead of
line-by-line istringstream parsing.
"""
from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "int8": "i1", "uint8": "u1",
    "int16": "i2", "uint16": "u2", "int32": "i4", "uint32": "u4",
    "float": "f4", "double": "f8", "float32": "f4", "float64": "f8",
}


def load_ply(path: str):
    """Returns (v0, v1, v2, n0, n1, n2) float32 arrays, uv arrays zeroed.

    Matches reference behavior: if the file has no normals, face normals are
    generated (src/scene.cpp:839-843)."""
    with open(path, "rb") as f:
        data = f.read()

    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_name, dtype) ...], list_props)
    for line in header:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append({"name": tok[1], "count": int(tok[2]),
                             "props": []})
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1]["props"].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1]["props"].append(("scalar", tok[1], tok[2]))

    verts = None
    vprops = None
    faces = []
    if fmt == "ascii":
        lines = body.split(b"\n")
        pos = 0
        for e in elements:
            n = e["count"]
            block = lines[pos:pos + n]
            pos += n
            if e["name"] == "vertex":
                vprops = [p[2] for p in e["props"] if p[0] == "scalar"]
                arr = np.genfromtxt((l for l in block), dtype=np.float32)
                verts = arr.reshape(n, -1)
            elif e["name"] == "face":
                for l in block:
                    t = l.split()
                    if not t:
                        continue
                    k = int(t[0])
                    idx = [int(x) for x in t[1:1 + k]]
                    for j in range(1, k - 1):  # fan triangulation
                        faces.append((idx[0], idx[j], idx[j + 1]))
    elif fmt == "binary_little_endian":
        off = 0
        for e in elements:
            n = e["count"]
            if all(p[0] == "scalar" for p in e["props"]):
                dt = np.dtype([(p[2], "<" + _PLY_DTYPES[p[1]])
                               for p in e["props"]])
                arr = np.frombuffer(body, dt, count=n, offset=off)
                off += dt.itemsize * n
                if e["name"] == "vertex":
                    vprops = [p[2] for p in e["props"]]
                    verts = np.stack(
                        [arr[p].astype(np.float32) for p in vprops], axis=1)
            else:
                # list property (faces)
                cdt = np.dtype("<" + _PLY_DTYPES[e["props"][0][1]])
                idt = np.dtype("<" + _PLY_DTYPES[e["props"][0][2]])
                rows = _uniform_rows(body, off, n, cdt, idt)
                if rows is not None:
                    off += n * (cdt.itemsize + idt.itemsize * rows.shape[1])
                    if e["name"] == "face":
                        faces.append(_fan(rows))
                    continue
                for _ in range(n):
                    k = int(np.frombuffer(body, cdt, 1, off)[0])
                    off += cdt.itemsize
                    idx = np.frombuffer(body, idt, k, off)
                    off += idt.itemsize * k
                    if e["name"] == "face":
                        for j in range(1, k - 1):
                            faces.append((int(idx[0]), int(idx[j]),
                                          int(idx[j + 1])))
    else:
        raise ValueError(f"unsupported PLY format {fmt}")

    f = _face_array(faces)
    if verts is None or not len(f):
        raise ValueError(f"{path}: no vertex/face data")

    names = {p: i for i, p in enumerate(vprops)}
    pos3 = verts[:, [names["x"], names["y"], names["z"]]]
    v0, v1, v2 = pos3[f[:, 0]], pos3[f[:, 1]], pos3[f[:, 2]]
    if "nx" in names:
        nrm = verts[:, [names["nx"], names["ny"], names["nz"]]]
        n0, n1, n2 = nrm[f[:, 0]], nrm[f[:, 1]], nrm[f[:, 2]]
    else:
        fn = np.cross(v1 - v0, v2 - v0)
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
        n0 = n1 = n2 = fn
    z2 = np.zeros((len(f), 2), np.float32)
    return (v0.astype(np.float32), v1.astype(np.float32),
            v2.astype(np.float32), n0.astype(np.float32),
            n1.astype(np.float32), n2.astype(np.float32), z2, z2, z2)


def _uniform_rows(body: bytes, off: int, n: int, cdt, idt):
    """The (n, k) index rows of a binary list element whose every row has
    the first row's length k, read through one strided view; None when
    the lengths differ (or the data ends early)."""
    if n == 0 or off + cdt.itemsize > len(body):
        return None
    k = int(np.frombuffer(body, cdt, 1, off)[0])
    stride = cdt.itemsize + idt.itemsize * k
    if k < 0 or off + n * stride > len(body):
        return None
    rec = np.dtype({"names": ["c", "i"],
                    "formats": [cdt, (idt, (k,))],
                    "offsets": [0, cdt.itemsize], "itemsize": stride})
    arr = np.frombuffer(body, rec, n, off)
    if not np.all(arr["c"] == k):
        return None
    return arr["i"].astype(np.int64).reshape(n, k)


def _fan(rows: np.ndarray) -> np.ndarray:
    """Fan triangles (idx0, idxj, idxj+1) of each row, row by row."""
    k = rows.shape[1]
    if k < 3:
        return np.zeros((0, 3), np.int64)
    j = np.arange(1, k - 1)
    tri = np.stack([np.broadcast_to(rows[:, :1], (len(rows), k - 2)),
                    rows[:, j], rows[:, j + 1]], axis=-1)
    return tri.reshape(-1, 3)


def _face_array(faces) -> np.ndarray:
    """The (F, 3) int64 faces from a mix of fanned blocks and single
    (a, b, c) tuples, in file order."""
    parts, run = [], []
    for f in faces:
        if isinstance(f, np.ndarray):
            if run:
                parts.append(np.asarray(run, np.int64))
                run = []
            parts.append(f)
        else:
            run.append(f)
    if run:
        parts.append(np.asarray(run, np.int64))
    if not parts:
        return np.zeros((0, 3), np.int64)
    return np.concatenate(parts).reshape(-1, 3)
