"""Extract rendering gain-matrix data from the reference decoder binaries.

The IAMF renderer uses static per-(input layout, output layout) gain matrices
(derived from ITU-R BS.2127-0 / the EAR Direct Speakers renderer, plus IAMF
§7.3.2.1 for 3.1.2/7.1.2 — see reference m2m_rdr.c:833-835) and static HOA
decode matrices (h2m_rdr.c:1002-1062). These are *numeric data*, not code; we
read them out of the compiled BSD-licensed reference libraries via ctypes and
store them as .npz for the device renderer (dsp/render_m2m.py, dsp/render_h2m.py).

Two variants exist: the default (spec/EAR) set and the SAMSUNG_TV set
(m2m_rdr.c:36). Both are stored.

Usage: python -m iamf_tpu.tools.extract_render_tables \
           --std /tmp/refbuild_std/libiamf.so --tv /tmp/refbuild/libiamf.so \
           --out iamf_tpu/dsp/data/render_tables.npz
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np

N_M2M = 10 * 14  # 10 input layouts x 14 output layouts (m2m_rdr.c:1629-1778)
N_H2M = 4 * 14  # ZOA/FOA/SOA/TOA x 14 outputs (h2m_rdr.c:1002-1062)


class M2MEntry(ctypes.Structure):
    _fields_ = [
        ("in_sys", ctypes.c_int),
        ("out_sys", ctypes.c_int),
        ("mat", ctypes.POINTER(ctypes.c_float)),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
    ]


class H2MEntry(ctypes.Structure):
    _fields_ = [
        ("in_order", ctypes.c_int),
        ("out_sys", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("lfe1", ctypes.c_int),
        ("lfe2", ctypes.c_int),
        ("mat", ctypes.POINTER(ctypes.c_float)),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
    ]


def extract(so_path: str) -> dict:
    lib = ctypes.CDLL(so_path)
    out = {}

    m2m = (M2MEntry * N_M2M).in_dll(lib, "m2m_rdr_tab")
    for e in m2m:
        # mat is in-major [m, n] (render_M2M: mat[m * n_size + n])
        mat = np.ctypeslib.as_array(e.mat, shape=(e.m, e.n)).copy()
        out[f"m2m/{e.in_sys:x}/{e.out_sys:x}"] = mat.astype(np.float32)

    h2m = (H2MEntry * N_H2M).in_dll(lib, "h2m_rdr_tab")
    for e in h2m:
        # mat is out-major [n, m] (render_H2M: mat[n * m_size + m])
        mat = np.ctypeslib.as_array(e.mat, shape=(e.n, e.m)).copy()
        out[f"h2m/{e.in_order}/{e.out_sys:x}"] = mat.astype(np.float32)
        out[f"h2m_meta/{e.in_order}/{e.out_sys:x}"] = np.array(
            [e.channels, e.lfe1, e.lfe2], dtype=np.int32
        )
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--std", required=True, help="libiamf.so built SAMSUNG_TV=OFF")
    ap.add_argument("--tv", required=True, help="libiamf.so built SAMSUNG_TV=ON")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    data = {}
    for prefix, path in (("std", args.std), ("tv", args.tv)):
        for k, v in extract(path).items():
            data[f"{prefix}/{k}"] = v
    np.savez_compressed(args.out, **data)
    print(f"wrote {len(data)} arrays to {args.out}")


if __name__ == "__main__":
    main()
