"""ctypes bindings for the native C++ host runtime.

The device compute path is JAX/XLA; the host runtime around it
(MSH parsing, sparsity-structure building) has C++ fast paths here, the
analog of the reference's compiled Rust host loops. Everything degrades
gracefully to the numpy implementations when the shared library is missing
or the toolchain can't build it (`MAGNETITE_NO_NATIVE=1` disables
explicitly).

Build: `make -C magnetite_tpu/_native` (done automatically on first use
when g++ exists). The C++ sources + Makefile ship as package data, so
installed copies self-build too (read-only site-packages degrade to numpy).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "_native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libmagnetite_native.so")

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def _so_current() -> bool:
    """True when the built library exists and is newer than every source."""
    try:
        so_mtime = os.path.getmtime(_SO_PATH)
    except OSError:
        return False
    src_dir = os.path.join(_NATIVE_DIR, "src")
    sources = [os.path.join(_NATIVE_DIR, "Makefile")]
    try:
        sources += [
            os.path.join(src_dir, f)
            for f in os.listdir(src_dir)
            if f.endswith((".cpp", ".h"))
        ]
    except OSError:
        return True  # sources absent (trimmed install): use what exists
    try:
        # strictly newer: a source edited within the same timestamp granule
        # as the last build (1 s on some filesystems, or mtime-preserving
        # copies) must trigger a rebuild, not silently load the stale .so
        return all(so_mtime > os.path.getmtime(s) for s in sources)
    except OSError:
        return False


def _try_build(force: bool = False) -> bool:
    cmd = ["make", "-C", _NATIVE_DIR] + (["-B"] if force else [])
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120
        )
        return proc.returncode == 0 and os.path.exists(_SO_PATH)
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("MAGNETITE_NO_NATIVE") == "1":
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        # run make only when the .so is missing or older than any source:
        # a current library skips the subprocess entirely (read-only
        # installs and toolchain-less boxes would otherwise pay a failing
        # `make` in every interpreter). A stale-but-present library still
        # rebuilds, and one whose symbols are missing despite a fresh mtime
        # is caught by the bind failure below.
        if not _so_current():
            _try_build()
        if not os.path.exists(_SO_PATH):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
            _bind(lib)
        except (OSError, AttributeError):
            # a library missing current symbols despite a fresh mtime (e.g.
            # hand-built from older sources): force a full rebuild so the
            # NEXT interpreter gets the fixed file (dlopen caches the stale
            # image in this process), and degrade to numpy here
            _try_build(force=True)
            _load_failed = True
            return None
        _lib = lib
        return _lib


def _bind(lib) -> None:
    """Declare every exported symbol (raises AttributeError when stale)."""
    i64 = ctypes.c_int64
    lib.msh_count.restype = ctypes.c_int
    lib.msh_count.argtypes = [
        ctypes.c_char_p, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i64),
    ]
    lib.msh_fill.restype = ctypes.c_int
    lib.msh_fill.argtypes = [
        ctypes.c_char_p, i64,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        i64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.ell_structure_width.restype = i64
    lib.ell_structure_width.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        i64, i64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    lib.ell_structure_fill.restype = ctypes.c_int
    lib.ell_structure_fill.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        i64, i64, i64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    lib.dia_structure.restype = i64
    lib.dia_structure.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        i64, i64, i64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.amg_assemble.restype = ctypes.c_int
    lib.amg_assemble.argtypes = [
        f64p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        i64,
        f64p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        i64p, f64p,
    ]
    lib.sort_reduce_blocks.restype = i64
    lib.sort_reduce_blocks.argtypes = [
        i64p, f64p, i64, i64, i64p, f64p,
    ]
    lib.assemble_coo_blocks.restype = i64
    lib.assemble_coo_blocks.argtypes = [
        f64p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        i64, f64p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        i64, i64p, f64p,
    ]
    lib.coo_matvec_blocks.restype = ctypes.c_int
    lib.coo_matvec_blocks.argtypes = [
        i64p, f64p, i64, i64, i64, f64p, f64p,
    ]
    lib.smooth_prolongator_blocks.restype = i64
    lib.smooth_prolongator_blocks.argtypes = [
        i64p, f64p, i64, i64, i64, f64p, f64p, i64, i64p, i64,
        ctypes.c_double, i64p, f64p,
    ]
    lib.rap_blocks.restype = i64
    lib.rap_blocks.argtypes = [
        i64p, f64p, i64, i64, i64, i64p, f64p, i64, i64, i64,
        i64p, f64p, i64,
    ]


def available() -> bool:
    return load() is not None


# ------------------------------- wrappers ----------------------------------


def msh_parse(text: str):
    """Native MSH 4.1 parse -> (coords [N,2] f64, tris [E,3] i32) or None.

    Returns None when the native library is unavailable; raises ValueError
    for malformed input the same way the numpy parser does.
    """
    lib = load()
    if lib is None:
        return None
    buf = text.encode()
    n_nodes = ctypes.c_int64()
    n_tris = ctypes.c_int64()
    max_tag = ctypes.c_int64()
    rc = lib.msh_count(
        buf, len(buf),
        ctypes.byref(n_nodes), ctypes.byref(n_tris), ctypes.byref(max_tag),
    )
    if rc == -1:
        raise ValueError("mesh file has no $Nodes section")
    if rc == -2:
        raise ValueError("mesh file has no 2D elements")
    if rc == -3:
        raise ValueError("unsupported 2D element type (only 3-node triangles)")
    if rc != 0 or n_tris.value == 0:
        raise ValueError("mesh file has no 2D elements")

    coords = np.zeros((max_tag.value, 2), dtype=np.float64)
    tags = np.zeros(n_nodes.value, dtype=np.int64)
    tris = np.zeros((n_tris.value, 3), dtype=np.int32)
    rc = lib.msh_fill(buf, len(buf), coords, tags, max_tag.value, tris)
    if rc != 0:
        raise ValueError(f"malformed mesh file (native parser code {rc})")

    if n_nodes.value != max_tag.value:
        # sparse tags: compact through the live set
        live = np.zeros(max_tag.value, dtype=bool)
        live[tags - 1] = True
        remap = -np.ones(max_tag.value, dtype=np.int64)
        remap[live] = np.arange(int(live.sum()))
        coords = coords[live]
        tris = remap[tris].astype(np.int32)
        if (tris < 0).any():
            raise ValueError("element references unknown node tag")
    return coords, tris


def ell_structure(tris: np.ndarray, n_nodes: int):
    """Native block-ELL structure -> (cols [N,K] i32, slot_ids [9E] i32,
    width) or None."""
    lib = load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    e = tris.shape[0]
    scratch = np.empty(9 * e, dtype=np.int64)
    width = lib.ell_structure_width(tris, e, n_nodes, scratch)
    if width < 0:
        raise ValueError("element node index out of range")
    cols = np.empty((n_nodes, width), dtype=np.int32)
    slot_ids = np.empty(9 * e, dtype=np.int32)
    rc = lib.ell_structure_fill(tris, e, n_nodes, width, cols, slot_ids, scratch)
    if rc != 0:
        raise ValueError(f"ELL structure build failed (code {rc})")
    return cols, slot_ids, int(width)


def amg_assemble(coords, tris, free_mask, e_mod, nu, t, slot_ids_pm, n_slots):
    """Native BC-masked closed-form assembly into ELL-flat [n_slots, 4]
    storage (fem/amg._assemble_block_coo's hot loop), or None."""
    lib = load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    free_mask = np.ascontiguousarray(free_mask, dtype=np.float64)
    slot_ids_pm = np.ascontiguousarray(slot_ids_pm, dtype=np.int64)
    flat = np.zeros((int(n_slots), 4), dtype=np.float64)
    lib.amg_assemble(
        coords, tris, tris.shape[0], free_mask,
        float(e_mod), float(nu), float(t), slot_ids_pm, flat,
    )
    return flat


def sort_reduce_blocks(keys: np.ndarray, vals: np.ndarray):
    """Native duplicate-key block reduction -> (uniq_keys, sums) or None."""
    lib = load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    shape = vals.shape[1:]
    if keys.size == 0:
        return keys.copy(), np.empty((0,) + shape)
    flat = np.ascontiguousarray(
        vals.reshape(vals.shape[0], -1), dtype=np.float64
    )
    out_keys = np.empty(keys.size, dtype=np.int64)
    out_vals = np.empty_like(flat)
    u = lib.sort_reduce_blocks(
        keys, flat, keys.size, flat.shape[1], out_keys, out_vals
    )
    return out_keys[:u].copy(), out_vals[:u].reshape(-1, *shape).copy()


def assemble_coo_blocks(coords, tris, free_mask, e_mod, nu, t, n_nodes):
    """Native direct block-COO stiffness assembly -> (keys [u] sorted,
    vals [u,2,2]) with keys = row*n + col, or None."""
    lib = load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    free_mask = np.ascontiguousarray(free_mask, dtype=np.float64)
    total = 9 * tris.shape[0]
    out_keys = np.empty(max(total, 1), dtype=np.int64)
    out_vals = np.empty((max(total, 1), 4), dtype=np.float64)
    u = lib.assemble_coo_blocks(
        coords, tris, tris.shape[0], free_mask,
        float(e_mod), float(nu), float(t), int(n_nodes), out_keys, out_vals,
    )
    return out_keys[:u].copy(), out_vals[:u].reshape(-1, 2, 2).copy()


def coo_matvec_blocks(keys, vals, n, x):
    """Native block-COO matvec -> y [n, m], or None."""
    lib = load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    m = vals.shape[1]
    flat = np.ascontiguousarray(vals.reshape(vals.shape[0], -1), np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.empty((int(n), m), dtype=np.float64)
    lib.coo_matvec_blocks(keys, flat, keys.size, m, int(n), x, y)
    return y


def smooth_prolongator_blocks(
    a_keys, a_vals, n, diag_inv, p0, agg, n_agg, omega
):
    """Native P = (I - omega Dinv A) P0 -> (keys [u] = i*n_agg + a sorted,
    vals [u, m, mc]), or None."""
    lib = load()
    if lib is None:
        return None
    a_keys = np.ascontiguousarray(a_keys, dtype=np.int64)
    m, mc = p0.shape[1], p0.shape[2]
    a_flat = np.ascontiguousarray(a_vals.reshape(a_vals.shape[0], -1), np.float64)
    di_flat = np.ascontiguousarray(diag_inv.reshape(diag_inv.shape[0], -1), np.float64)
    p0_flat = np.ascontiguousarray(p0.reshape(p0.shape[0], -1), np.float64)
    agg = np.ascontiguousarray(agg, dtype=np.int64)
    total = a_keys.size + int(n)
    out_keys = np.empty(total, dtype=np.int64)
    out_vals = np.empty((total, m * mc), dtype=np.float64)
    u = lib.smooth_prolongator_blocks(
        a_keys, a_flat, a_keys.size, m, int(n), di_flat, p0_flat, mc,
        agg, int(n_agg), float(omega), out_keys, out_vals,
    )
    return out_keys[:u].copy(), out_vals[:u].reshape(-1, m, mc).copy()


def rap_blocks(a_keys, a_vals, n, p_keys, p_vals, n_agg):
    """Native Galerkin C = P^T A P -> (keys [u] = b*n_agg + a sorted,
    vals [u, mc, mc]), or None."""
    lib = load()
    if lib is None:
        return None
    a_keys = np.ascontiguousarray(a_keys, dtype=np.int64)
    p_keys = np.ascontiguousarray(p_keys, dtype=np.int64)
    m = a_vals.shape[1]
    mc = p_vals.shape[2]
    a_flat = np.ascontiguousarray(a_vals.reshape(a_vals.shape[0], -1), np.float64)
    p_flat = np.ascontiguousarray(p_vals.reshape(p_vals.shape[0], -1), np.float64)
    cap = 64 * int(n_agg) + 64
    for _ in range(3):
        try:
            out_keys = np.empty(cap, dtype=np.int64)
            out_vals = np.empty((cap, mc * mc), dtype=np.float64)
        except MemoryError:
            # the 8x-per-retry growth can outrun host RAM on pathological
            # coarse fill -- fall through to the chunked numpy path
            # instead of crashing the solve
            return None
        u = lib.rap_blocks(
            a_keys, a_flat, a_keys.size, m, int(n),
            p_keys, p_flat, p_keys.size, mc, int(n_agg),
            out_keys, out_vals, cap,
        )
        if u >= 0:
            return out_keys[:u].copy(), out_vals[:u].reshape(-1, mc, mc).copy()
        cap *= 8  # pathological coarse fill: retry, then numpy fallback
    return None


def dia_structure(tris: np.ndarray, n_nodes: int, max_diags: int):
    """Native DIA structure -> (offsets [D] i64, slot_ids [9E] i32) or
    None if unavailable; False if the mesh exceeds max_diags."""
    lib = load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    e = tris.shape[0]
    offsets = np.empty(min(max_diags, 512), dtype=np.int64)
    slot_ids = np.empty(9 * e, dtype=np.int32)
    n_diags = lib.dia_structure(
        tris, e, n_nodes, min(max_diags, 512), offsets, slot_ids
    )
    if n_diags < 0:
        return False
    return offsets[:n_diags].copy(), slot_ids
