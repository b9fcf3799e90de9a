"""Standard 3DGS gaussian PLY export and import (INRIA field layout), and
the ``.splat`` web-viewer format.

Counterpart of ``gsplat_tpu/data/gsply.py``: ``export_gaussians_ply``
(``:45``), ``export_gaussians_splat`` (``:112``) and
``import_gaussians_ply`` (``:160``). The PLY fields:

    x y z nx ny nz f_dc_0..2 f_rest_0..(3*(B^2-1)-1) opacity
    scale_0..2 rot_0..3

Conventions mapped at this boundary (as data/colmap.py maps COLMAP
quaternions):
* rot is stored (w, x, y, z); the pool uses (x, y, z, w).
* f_rest is stored CHANNEL-MAJOR (all R coefficients, then G, then B);
  the pool keeps the coefficient-major [15, 3] interleave.
* opacity and scales are raw (pre-sigmoid / log-space) in both.

Colour model: this package computes ``color = sigmoid(sum f_k Y_k)``;
INRIA viewers compute ``0.5 + sum f_k Y_k``. ``convert_colors=False``
(default) round-trips losslessly within this package;
``convert_colors=True`` remaps the DC term so that the view-independent
colour matches in an external viewer (f_rest scaled by the local sigmoid
slope), approximate for strongly view-dependent gaussians.
"""

from __future__ import annotations

import numpy as np

SH_C0 = 0.28209479177387814  # Y_0 basis constant


def _fields(num_rest: int) -> list[str]:
    return (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(num_rest)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )


def export_gaussians_ply(
    path: str,
    params: dict,
    alive: np.ndarray | None = None,
    convert_colors: bool = False,
) -> int:
    """Write the pool to a standard 3DGS PLY. Returns gaussians written."""
    pos = np.asarray(params["pos"], np.float32)
    f_dc = np.asarray(params["f_dc"], np.float32)
    f_rest = np.asarray(params["f_rest"], np.float32)
    opacity = np.asarray(params["opacity_raw"], np.float32)
    scale = np.asarray(params["scale_raw"], np.float32)
    quat = np.asarray(params["q_raw"], np.float32)

    if alive is not None:
        keep = np.asarray(alive, bool)
        pos, f_dc, f_rest = pos[keep], f_dc[keep], f_rest[keep]
        opacity, scale, quat = opacity[keep], scale[keep], quat[keep]
    n = pos.shape[0]
    num_rest = f_rest.shape[1]

    if convert_colors:
        # Match the view-independent color under the INRIA transfer:
        # sigmoid(f_dc * C0) == 0.5 + f_dc' * C0. Scale the higher-order
        # coefficients by the sigmoid slope at the operating point so small
        # view-dependent variations keep their first-order effect.
        act = 1.0 / (1.0 + np.exp(-f_dc * SH_C0))
        f_dc_out = (act - 0.5) / SH_C0
        slope = act * (1.0 - act)  # d sigmoid / d logit, per channel
        k = f_rest.shape[1] // 3
        rest_cm = f_rest.reshape(n, k, 3)
        rest_cm = rest_cm * slope[:, None, :]
        f_dc, f_rest = f_dc_out.astype(np.float32), rest_cm.reshape(
            n, num_rest
        ).astype(np.float32)

    # coefficient-major [k, 3] -> channel-major [3, k]
    k = num_rest // 3
    rest_chan = (
        f_rest.reshape(n, k, 3).transpose(0, 2, 1).reshape(n, num_rest)
    )
    # (x, y, z, w) -> (w, x, y, z), normalized (viewers expect unit quats)
    qn = quat / (np.linalg.norm(quat, axis=1, keepdims=True) + 1e-12)
    rot = np.concatenate([qn[:, 3:4], qn[:, 0:3]], axis=1)

    cols = np.concatenate(
        [
            pos,
            np.zeros((n, 3), np.float32),  # normals (unused, layout-required)
            f_dc,
            rest_chan,
            opacity[:, None],
            scale,
            rot,
        ],
        axis=1,
    ).astype("<f4")

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {f}" for f in _fields(num_rest)]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(cols.tobytes())
    return n


def export_gaussians_splat(
    path: str,
    params: dict,
    alive: np.ndarray | None = None,
) -> int:
    """Write the pool as a ``.splat`` file (antimatter15 web-viewer format).

    32 bytes per gaussian: position f32x3, LINEAR scale f32x3 (exp of the
    log-scale), color RGBA u8 (our sigmoid transfer's view-independent
    color + sigmoid opacity), rotation u8x4 ((w,x,y,z) normalized quat
    mapped q*128+128). Gaussians are sorted by size x opacity descending,
    as the usual converters sort them, so progressive loading shows the
    big splats first. Returns the number written.
    """
    pos = np.asarray(params["pos"], np.float32)
    f_dc = np.asarray(params["f_dc"], np.float32)
    opacity = np.asarray(params["opacity_raw"], np.float32)
    scale = np.asarray(params["scale_raw"], np.float32)
    quat = np.asarray(params["q_raw"], np.float32)
    if alive is not None:
        keep = np.asarray(alive, bool)
        pos, f_dc = pos[keep], f_dc[keep]
        opacity, scale, quat = opacity[keep], scale[keep], quat[keep]
    n = pos.shape[0]

    lin_scale = np.exp(scale)
    sig_op = 1.0 / (1.0 + np.exp(-opacity))
    order = np.argsort(-(lin_scale.prod(axis=1) * sig_op))
    pos, f_dc = pos[order], f_dc[order]
    sig_op, lin_scale, quat = sig_op[order], lin_scale[order], quat[order]

    rgb = 1.0 / (1.0 + np.exp(-f_dc * SH_C0))  # our sigmoid transfer
    rgba = np.concatenate([rgb, sig_op[:, None]], axis=1)
    rgba_u8 = np.clip(rgba * 255.0 + 0.5, 0, 255).astype(np.uint8)
    qn = quat / (np.linalg.norm(quat, axis=1, keepdims=True) + 1e-12)
    rot_wxyz = np.concatenate([qn[:, 3:4], qn[:, 0:3]], axis=1)
    rot_u8 = np.clip(rot_wxyz * 128.0 + 128.0, 0, 255).astype(np.uint8)

    buf = np.zeros((n, 32), np.uint8)
    buf[:, 0:12] = pos.astype("<f4").view(np.uint8).reshape(n, 12)
    buf[:, 12:24] = lin_scale.astype("<f4").view(np.uint8).reshape(n, 12)
    buf[:, 24:28] = rgba_u8
    buf[:, 28:32] = rot_u8
    with open(path, "wb") as f:
        f.write(buf.tobytes())
    return n


def import_gaussians_ply(path: str) -> dict:
    """Read a standard 3DGS PLY into a core params dict (numpy arrays).

    Accepts any f_rest width divisible by 3 (SH bands 0-3). Unknown extra
    properties are ignored; missing required ones raise.
    """
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n = None
        props = []
        fmt = None
        for line in header:
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                props.append(line.split()[-1])
            elif line.startswith("property"):
                raise ValueError(
                    f"unsupported (non-float) property: {line!r}"
                )
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt!r}")
        if n is None:
            raise ValueError("no vertex element in PLY header")
        data = np.frombuffer(
            f.read(n * len(props) * 4), dtype="<f4"
        ).reshape(n, len(props))

    col = {name: i for i, name in enumerate(props)}

    def take(names):
        missing = [nm for nm in names if nm not in col]
        if missing:
            raise ValueError(f"PLY missing gaussian fields: {missing}")
        return data[:, [col[nm] for nm in names]]

    pos = take(["x", "y", "z"])
    f_dc = take(["f_dc_0", "f_dc_1", "f_dc_2"])
    rest_names = sorted(
        (nm for nm in col if nm.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    num_rest = len(rest_names)
    if num_rest % 3:
        raise ValueError(f"f_rest width {num_rest} not divisible by 3")
    rest_chan = data[:, [col[nm] for nm in rest_names]]
    k = num_rest // 3
    f_rest = (
        rest_chan.reshape(n, 3, k).transpose(0, 2, 1).reshape(n, num_rest)
        if num_rest
        else np.zeros((n, 0), np.float32)
    )
    opacity = take(["opacity"])[:, 0]
    scale = take(["scale_0", "scale_1", "scale_2"])
    rot_wxyz = take(["rot_0", "rot_1", "rot_2", "rot_3"])
    quat = np.concatenate([rot_wxyz[:, 1:4], rot_wxyz[:, 0:1]], axis=1)

    return {
        "pos": np.ascontiguousarray(pos, np.float32),
        "f_dc": np.ascontiguousarray(f_dc, np.float32),
        "f_rest": np.ascontiguousarray(f_rest, np.float32),
        "opacity_raw": np.ascontiguousarray(opacity, np.float32),
        "scale_raw": np.ascontiguousarray(scale, np.float32),
        "q_raw": np.ascontiguousarray(quat, np.float32),
    }
