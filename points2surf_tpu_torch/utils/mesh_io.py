"""Mesh and point-cloud IO (counterpart of
``points2surf_tpu/utils/mesh_io.py``): ASCII OFF/COFF, PLY (ascii and binary
little endian), XYZ and BlenSor's ASCII PCD. The writers produce the same
bytes as the JAX package's for the same arrays.
"""

from __future__ import annotations

import numpy as np

from points2surf_tpu_torch.utils import file_utils


# ---------------------------------------------------------------- OFF ----


def write_off(path: str, vertices: np.ndarray, faces=None, colors_vertex=None):
    """ASCII OFF/COFF writer (reference mesh_io.py:84-135)."""
    file_utils.make_dir_for_file(path)
    vertices = np.asarray(vertices)
    faces = np.asarray(faces if faces is not None else [], dtype=np.int64)
    with open(path, "w") as f:
        if colors_vertex is not None and len(colors_vertex):
            f.write("COFF\n")
        else:
            f.write("OFF\n")
        f.write(f"{len(vertices)} {len(faces)} 0\n")
        if colors_vertex is not None and len(colors_vertex):
            c = np.asarray(colors_vertex)
            if c.max() <= 1.0:
                c = c * 255.0
            c = c.astype(np.int32)
            for v, col in zip(vertices, c):
                f.write(
                    f"{v[0]} {v[1]} {v[2]} {col[0]} {col[1]} {col[2]} 255\n"
                )
        else:
            for v in vertices:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in faces.reshape(-1, 3) if faces.size else []:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def read_off(path: str):
    """ASCII OFF/COFF reader -> (vertices (V,3) f32, faces (F,3) i64)."""
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    header = tokens[i]
    i += 1
    if header not in ("OFF", "COFF"):
        raise ValueError(f"not an OFF file: {path}")
    has_color = header == "COFF"
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3  # skip edge count
    stride = 7 if has_color else 3
    vdata = np.asarray(tokens[i : i + nv * stride], np.float64).reshape(
        nv, stride
    )
    vertices = vdata[:, :3].astype(np.float32)
    i += nv * stride
    faces = []
    for _ in range(nf):
        cnt = int(tokens[i])
        poly = [int(t) for t in tokens[i + 1 : i + 1 + cnt]]
        i += 1 + cnt
        for j in range(1, cnt - 1):  # fan-triangulate
            faces.append((poly[0], poly[j], poly[j + 1]))
    return vertices, np.asarray(faces, np.int64).reshape(-1, 3)


# ---------------------------------------------------------------- PLY ----


def write_ply(
    path: str,
    vertices: np.ndarray,
    faces=None,
    colors=None,
    normals=None,
    binary: bool = True,
):
    """PLY writer (binary_little_endian by default)."""
    file_utils.make_dir_for_file(path)
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    f_arr = (
        np.asarray(faces, np.int32).reshape(-1, 3)
        if faces is not None and len(faces)
        else None
    )
    c = None
    if colors is not None and len(colors):
        c = np.asarray(colors)
        if c.max() <= 1.0:
            c = c * 255.0
        c = np.clip(c, 0, 255).astype(np.uint8).reshape(-1, 3)
    n_arr = (
        np.asarray(normals, np.float32).reshape(-1, 3)
        if normals is not None and len(normals)
        else None
    )

    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append(f"element vertex {len(v)}")
    header += ["property float x", "property float y", "property float z"]
    if n_arr is not None:
        header += ["property float nx", "property float ny", "property float nz"]
    if c is not None:
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    if f_arr is not None:
        header.append(f"element face {len(f_arr)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode())
        if binary:
            rec_fields = [("xyz", "<f4", 3)]
            if n_arr is not None:
                rec_fields.append(("n", "<f4", 3))
            if c is not None:
                rec_fields.append(("rgb", "u1", 3))
            rec = np.empty(len(v), dtype=rec_fields)
            rec["xyz"] = v
            if n_arr is not None:
                rec["n"] = n_arr
            if c is not None:
                rec["rgb"] = c
            fh.write(rec.tobytes())
            if f_arr is not None:
                frec = np.empty(
                    len(f_arr), dtype=[("cnt", "u1"), ("idx", "<i4", 3)]
                )
                frec["cnt"] = 3
                frec["idx"] = f_arr
                fh.write(frec.tobytes())
        else:
            for i in range(len(v)):
                parts = [f"{v[i,0]} {v[i,1]} {v[i,2]}"]
                if n_arr is not None:
                    parts.append(f"{n_arr[i,0]} {n_arr[i,1]} {n_arr[i,2]}")
                if c is not None:
                    parts.append(f"{c[i,0]} {c[i,1]} {c[i,2]}")
                fh.write((" ".join(parts) + "\n").encode())
            if f_arr is not None:
                for face in f_arr:
                    fh.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode())


def read_ply(path: str):
    """PLY reader (ascii + binary little endian; x/y/z + faces).

    Returns (vertices (V,3) f32, faces (F,3) i64) — faces empty for clouds.
    """
    with open(path, "rb") as fh:
        data = fh.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header_text = data[:end].decode("ascii", "replace")
    body = data[end + len(b"end_header") + 1 :]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_name, dtype)...])
    cur = None
    for line in header_text.splitlines():
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = (t[1], int(t[2]), [])
            elements.append(cur)
        elif t[0] == "property" and cur is not None:
            if t[1] == "list":
                cur[2].append(("list", (t[2], t[3], t[4])))
            else:
                cur[2].append((t[4] if len(t) > 4 else t[2], t[1]))

    type_map = {
        "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
        "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
        "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
        "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    }

    vertices = np.zeros((0, 3), np.float32)
    faces = []
    if fmt.startswith("binary_little"):
        offset = 0
        for name, count, props in elements:
            if all(p[0] != "list" for p in props):
                dt = np.dtype(
                    [(p[0] + f"_{i}", type_map[p[1]]) for i, p in enumerate(props)]
                )
                arr = np.frombuffer(body, dt, count, offset)
                offset += dt.itemsize * count
                if name == "vertex":
                    names = [p[0] for p in props]
                    xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                    vertices = np.stack(
                        [
                            arr[f"x_{xi}"].astype(np.float32),
                            arr[f"y_{yi}"].astype(np.float32),
                            arr[f"z_{zi}"].astype(np.float32),
                        ],
                        axis=1,
                    )
            else:
                # list property (faces): parse sequentially
                cnt_t, idx_t = None, None
                for p in props:
                    if p[0] == "list":
                        cnt_t, idx_t = type_map[p[1][0]], type_map[p[1][1]]
                cnt_size = np.dtype(cnt_t).itemsize
                idx_size = np.dtype(idx_t).itemsize
                for _ in range(count):
                    cnt = int(np.frombuffer(body, cnt_t, 1, offset)[0])
                    offset += cnt_size
                    poly = np.frombuffer(body, idx_t, cnt, offset)
                    offset += idx_size * cnt
                    for j in range(1, cnt - 1):
                        faces.append((poly[0], poly[j], poly[j + 1]))
    else:
        lines = body.decode("ascii", "replace").splitlines()
        li = 0
        for name, count, props in elements:
            if name == "vertex":
                names = [p[0] for p in props]
                xi = names.index("x")
                rows = np.asarray(
                    [lines[li + i].split() for i in range(count)], np.float64
                )
                vertices = rows[:, xi : xi + 3].astype(np.float32)
                li += count
            else:
                for i in range(count):
                    t = lines[li + i].split()
                    cnt = int(t[0])
                    poly = [int(x) for x in t[1 : 1 + cnt]]
                    for j in range(1, cnt - 1):
                        faces.append((poly[0], poly[j], poly[j + 1]))
                li += count
    return vertices, np.asarray(faces, np.int64).reshape(-1, 3)


# ---------------------------------------------------------------- XYZ ----


def write_xyz(path: str, points: np.ndarray, normals=None, colors=None):
    """ASCII XYZ writer (reference point_cloud.py:63-104)."""
    file_utils.make_dir_for_file(path)
    points = np.asarray(points).reshape(-1, 3)
    cols = [points]
    if normals is not None:
        cols.append(np.asarray(normals).reshape(-1, 3))
    if colors is not None:
        cols.append(np.asarray(colors).reshape(-1, 3))
    np.savetxt(path, np.concatenate(cols, axis=1), fmt="%.8g")


def load_xyz(path: str) -> np.ndarray:
    """XYZ reader dropping NaN rows (reference point_cloud.py:14-21)."""
    data = np.loadtxt(path).astype(np.float32)
    data = np.atleast_2d(data)
    nan_rows = np.isnan(data).any(axis=1)
    return data[~nan_rows]


def load_mesh(path: str):
    """Dispatch by extension -> (vertices, faces)."""
    lower = path.lower()
    if lower.endswith(".off"):
        return read_off(path)
    if lower.endswith(".ply"):
        return read_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


# ---------------------------------------------------------------- PCD ----


def load_pcd(file_in: str):
    """BlenSor ASCII PCD reader (reference point_cloud.py:107-163).

    Returns (points (N, 3) float64, header dict); NaN rows (missed rays)
    are dropped.
    """
    with open(file_in) as f:
        lines = f.readlines()
    header_lines = lines[:11]
    expected = ["#", "VERSION", "FIELDS", "SIZE", "TYPE", "COUNT", "WIDTH",
                "HEIGHT", "VIEWPOINT", "POINTS", "DATA"]
    header = {}
    for ln, field in zip(header_lines, expected):
        parts = ln.split(" ")
        if parts[0] != field:
            raise ValueError(f'"{field}" expected but not found in pcd header')
        header[field] = " ".join(parts[1:]).strip()
    header["_file_"] = file_in
    rows = []
    for ln in lines[11:]:
        t = ln.split(" ")[:3]
        if len(t) < 3:
            continue
        x, y, z = float(t[0]), float(t[1]), float(t[2])
        if x == x and y == y and z == z:  # NaN filter
            rows.append((x, y, z))
    return np.asarray(rows, np.float64), header
