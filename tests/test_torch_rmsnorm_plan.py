"""The rmsnorm kernel's tiling and reduction order, on the CPU.

``kernels/rmsnorm/ops.plan`` lays a row over the threads of
csrc/rmsnorm.cu: a width class (threads per row x 16-byte vectors per
thread, the row held in registers) or the general path (the row staged
in shared memory from its first 16-byte boundary).  These tests hold
that tiling at every width the configs norm at, and emulate in numpy
the kernel's order of summation (per-thread sums with fused
multiply-adds, a butterfly over the row's lanes, then the warps'
partial sums in order) against the JAX package's ``rmsnorm`` (Pallas in
interpret mode), at the tolerances of tests/test_kernels.py: f32 2e-5
(summation order), bf16 2e-2 (one bf16 rounding of the output).  The
kernel itself is held against the plain version on the card by
chip_smoke.py."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import ops as jrms_ops
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.kernels.rmsnorm import ops

from _torch_parity import j2n

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ODD = (577, 4099, 4103, 18433)


def config_widths():
    """Every width a config norms at: d_model, full and reduced, and a
    hybrid (Mamba2) block's gated output, 2 * d_model."""
    out = set()
    for arch in list_archs():
        for cfg in (get_config(arch), get_reduced(arch)):
            out.add(cfg.d_model)
            if cfg.family == "hybrid":
                out.add(2 * cfg.d_model)
    return sorted(out)


WIDTHS = config_widths()


def kernel_source():
    return (pathlib.Path(ops.__file__).resolve().parents[2] / "csrc"
            / "rmsnorm.cu").read_text()


def class_owner(p, d, vec):
    """(thread, vector slot) of every value of a row under class ``p``:
    vector v of the row is slot v // T of thread v % T."""
    v = np.arange(d) // vec
    return v % p.threads_per_row, v // p.threads_per_row


def general_owner(p, d, vec, shift):
    """(thread, part) of every value of a row whose first value lies
    ``shift`` values past a 16-byte boundary: the scalar head up to the
    next boundary, the body's vectors dealt to the block's threads in
    turn, the scalar tail (part 0 head, 1 body, 2 tail)."""
    T = p.threads_per_row
    head = min((vec - shift) % vec, d)
    body = (d - head) // vec
    j = np.arange(d)
    thread = np.where(j < head, j, np.where(
        j < head + body * vec, ((j - head) // vec) % T,
        j - head - body * vec))
    part = np.where(j < head, 0, np.where(j < head + body * vec, 1, 2))
    return thread, part, head, body


def test_config_widths_cover_full_and_reduced_models():
    for d in (576, 1024, 2048, 3584, 4096, 7168, 18432, 96, 128, 192,
              256):
        assert d in WIDTHS


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", WIDTHS + list(ODD))
def test_plan_covers_every_value_once(d, dtype):
    tdt = DTYPES[dtype]
    vec = ops.vec_len(tdt)
    p = ops.plan(d, tdt)
    if p.kind == "class":
        assert d % vec == 0
        assert (p.threads_per_row, p.vecs_per_thread) in ops.CLASSES
        # a block (ROW_BLOCK threads, or one row's) holds whole rows
        assert max(p.threads_per_row, ops.ROW_BLOCK) % p.threads_per_row == 0
        assert ops.data_registers(p, tdt) <= ops.REG_BUDGET
        thread, slot = class_owner(p, d, vec)
        assert slot.max() < p.vecs_per_thread
        # each (thread, slot, lane) holds one value; the slots past the
        # row are masked whole vectors, fewer than a thread's row share
        held = thread * p.vecs_per_thread * vec + slot * vec + np.arange(d) % vec
        assert len(np.unique(held)) == d
        masked = p.threads_per_row * p.vecs_per_thread * vec - d
        assert masked % vec == 0 and 0 <= masked < p.threads_per_row * vec
        # the fewest threads that hold the row in MAX_VECS vectors each
        if p.threads_per_row > ops.MIN_THREADS:
            assert d > p.threads_per_row // 2 * ops.MAX_VECS * vec
    else:
        assert d % vec or d > ops.MAX_THREADS * ops.MAX_VECS * vec
        assert p.vecs_per_thread == 0
        lo, hi = ops.STAGED_THREADS
        assert lo <= p.threads_per_row <= hi
        for shift in range(vec):      # every alignment of a row's start
            thread, part, head, body = general_owner(p, d, vec, shift)
            assert thread.max() < p.threads_per_row
            assert (part == 1).sum() == body * vec
            assert head < vec and d - head - body * vec < vec
            # values of the body go whole vectors to one thread
            b = np.nonzero(part == 1)[0]
            assert (thread[b].reshape(-1, vec) == thread[b][::vec, None]).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_general_plan_at_every_width(dtype):
    """A view off a 16-byte boundary takes the general path at any width:
    a power of two of threads, about STAGED_VECS vectors each."""
    tdt = DTYPES[dtype]
    vec = ops.vec_len(tdt)
    lo, hi = ops.STAGED_THREADS
    for d in WIDTHS + list(ODD):
        g = ops.general_plan(d, tdt)
        T = g.threads_per_row
        assert g.kind == "general" and g.vecs_per_thread == 0
        assert lo <= T <= hi and T & (T - 1) == 0
        assert T == hi or T * ops.STAGED_VECS * vec >= d
        assert T == lo or T // 2 * ops.STAGED_VECS * vec < d


def test_classes_are_those_the_plan_reaches_and_the_kernel_compiles():
    reached = set()
    for tdt in DTYPES.values():
        vec = ops.vec_len(tdt)
        for d in range(vec, ops.MAX_THREADS * ops.MAX_VECS * vec + 1, vec):
            p = ops.plan(d, tdt)
            assert p.kind == "class"
            reached.add((p.threads_per_row, p.vecs_per_thread))
    assert reached == set(ops.CLASSES)
    src = kernel_source()
    macro = src[src.index("#define RMSNORM_CLASSES"):].split("\n\n")[0]
    compiled = [tuple(map(int, m)) for m in
                re.findall(r"C\((\d+), (\d+)\)", macro)]
    assert tuple(compiled) == ops.CLASSES


def test_kernel_constants_are_the_plans():
    """The block sizes the kernel is compiled with are those ``plan``
    lays rows out for."""
    src = kernel_source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kRowBlock") == ops.ROW_BLOCK
    assert const("kStagedMaxThreads") == ops.STAGED_THREADS[1]


@pytest.mark.parametrize("cls", ops.CLASSES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_every_class_within_register_budget(cls, dtype):
    p = ops.Plan("class", cls[0], cls[1], True)
    assert ops.data_registers(p, DTYPES[dtype]) <= ops.REG_BUDGET


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sdt", list(DTYPES))
@pytest.mark.parametrize("xdt", list(DTYPES))
def test_plan_code_packs_what_the_kernel_reads(xdt, sdt, aligned):
    """rt_rmsnorm unpacks the one int the wrapper passes: threads per row
    (16 bits), vectors per thread (8), x bf16, scale bf16, persistent."""
    x, s = DTYPES[xdt], DTYPES[sdt]
    for d in WIDTHS + list(ODD):
        code = ops.plan_code(d, x, s, aligned)
        p = ops.plan(d, x) if aligned else ops.general_plan(d, x)
        assert code & 0xffff == p.threads_per_row
        assert (code >> 16) & 0xff == p.vecs_per_thread
        assert (code >> 24) & 1 == (xdt == "bfloat16")
        assert (code >> 25) & 1 == (sdt == "bfloat16")
        assert (code >> 26) & 1 == p.persistent
        assert code >> 27 == 0
        # bf16 classes walk the rows with a persistent grid, f32 classes
        # take one block per row group; the general path is persistent
        assert p.persistent == (p.kind == "general" or xdt == "bfloat16")


# ------------------------------------------------ the kernel's summation
def fma(a, b, c):
    """float32 fused multiply-add: one rounding of a * b + c (the
    product of two f32 values is exact in f64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def butterfly(vals, width):
    """__shfl_xor_sync sums over aligned groups of ``width`` lanes of
    the last axis; every lane ends with the same bits."""
    lanes = np.arange(vals.shape[-1])
    off = width // 2
    while off:
        vals = (vals + vals[..., lanes ^ off]).astype(np.float32)
        off //= 2
    return vals


def warps_in_order(sums, threads):
    """Lane 0 of each warp's sum, added warp after warp."""
    part = sums[..., ::32]
    total = part[..., 0]
    for w in range(1, threads // 32):
        total = (total + part[..., w]).astype(np.float32)
    return total


def emulate(x, scale, p, vec, shift=0, eps=1e-5):
    """The kernel's arithmetic on rows ``x`` (f32 values of x's dtype):
    per-row sums of squares in its order, rsqrt, then (x * inv) * scale
    in f32."""
    rows, d = x.shape
    T = p.threads_per_row
    if p.kind == "class":
        n = T * p.vecs_per_thread * vec
        xp = np.zeros((rows, n), np.float32)
        xp[:, :d] = x
        # [row, slot, thread, lane]: vector i * T + t is slot i of thread t
        xv = xp.reshape(rows, p.vecs_per_thread, T, vec)
        ss = np.zeros((rows, T), np.float32)
        for i in range(p.vecs_per_thread):
            for j in range(vec):
                ss = fma(xv[:, i, :, j], xv[:, i, :, j], ss)
        ss = butterfly(ss, min(T, 32))
        total = ss[:, 0] if T <= 32 else warps_in_order(ss, T)
    else:
        thread, part, head, body = general_owner(p, d, vec, shift)
        ss = np.zeros((rows, T), np.float32)
        for k in range(0, body, T):           # the body, T vectors a turn
            for t in range(min(T, body - k)):
                j0 = head + (k + t) * vec
                for j in range(vec):
                    ss[:, t] = fma(x[:, j0 + j], x[:, j0 + j], ss[:, t])
        for j in np.nonzero(part != 1)[0]:    # head, then tail
            t = thread[j]
            ss[:, t] = fma(x[:, j], x[:, j], ss[:, t])
        total = warps_in_order(butterfly(ss, 32), T)
    mean = (total / np.float32(d)).astype(np.float32)
    inv = (np.float32(1) / np.sqrt(mean + np.float32(eps))).astype(np.float32)
    return ((x * inv[:, None]).astype(np.float32)
            * scale[None, :]).astype(np.float32)


CASES = [(37, 96), (37, 576), (5, 1024), (9, 2048), (5, 3584), (3, 7168),
         (5, 577), (3, 4099), (2, 18432), (111, 64)]


@pytest.mark.parametrize("rows,d", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_summation_matches_reference(rows, d, dtype):
    tdt = DTYPES[dtype]
    rng = np.random.RandomState(rows * d)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    s = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    want = j2n(jrms_ops.rmsnorm(jx, jnp.asarray(s)))
    xs = j2n(jx)                     # x's values after the dtype's rounding
    p = ops.plan(d, tdt)
    vec = ops.vec_len(tdt)
    shifts = (0,) if p.kind == "class" else (0, 1, vec - 1)
    for plan_, shift in [(p, s_) for s_ in shifts] + [
            (ops.general_plan(d, tdt), vec // 2)]:   # an odd-offset view
        got = torch.from_numpy(emulate(xs, s, plan_, vec, shift)).to(tdt)
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=tol, rtol=tol)
