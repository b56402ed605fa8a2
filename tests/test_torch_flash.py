"""The port's flash attention against the JAX package, on the CPU.

``repro_torch.kernels.flash_attention`` (CPU tensors take its plain
version) against the Pallas kernel run in interpret mode and against its
oracle ``repro.kernels.ref.flash_attention_ref``, on the sweep of
``tests/test_kernels_pallas.py`` (shapes, causal or not, bf16, decode
alignment).  Absolute limits are the JAX tests' own: 2e-5 in float32 and
5e-2 in bfloat16.  Rows that see no key are 0 in the port (the oracle
gives NaN there).

The card runs every dtype on tensor-core kernels that no CPU can run;
``_tile_emulation`` repeats their arithmetic tile by tile in plain PyTorch
(64-row blocks, float32 running max and normaliser, the causal stop at a
block's last row, 0 for rows with no visible key).  bfloat16 and float16
(wgmma): 64-key tiles, P split into hi + lo in the input dtype for the PV
product; the limit is two ulps of the output dtype, elementwise: |e - p| <=
2e-5 + r |p| with r = 2^-6 (bfloat16) or 2^-9 (float16), as on the card
(tests/test_torch_gpu.py).  float32 (TF32 mma.sync): the kernel's keys a
tile at each head dim, and every operand of both products (q, k, p, v)
split into a TF32 high part, rounded to nearest with ties away from zero
as ``cvt.rna`` rounds, and the rest truncated to TF32, by the kernel's own
bit operations; each product taken as hi hi + hi lo + lo hi; the limit is
the JAX tests' 2e-5 absolute.  The tests below
hold the emulation against the JAX kernel or its oracle and the plain
version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as tfa

RNG = np.random.default_rng(13)
LOG2E = 1.4426950408889634
# two ulps of the output dtype, (atol, rtol)
TWO_ULPS = {torch.bfloat16: (2e-5, 2.0 ** -6),
            torch.float16: (2e-5, 2.0 ** -9)}
# unit roundoff of each dtype (half an ulp at 1)
UNIT = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Under pytest-xdist's parallel workers torch's OpenMP threads
    oversubscribe the cores, and the s = 2048 emulation below stalls.  One
    thread here; the caller's count back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, hq, hkv, sq, sk, dh, rng=RNG):
    return (rng.normal(size=(b, hq, sq, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, dh)).astype(np.float32))


def _port(q, k, v, dtype=torch.float32, **kw):
    return tfa.flash_attention(*(torch.as_tensor(a).to(dtype)
                                 for a in (q, k, v)), **kw)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh", [
    (2, 4, 2, 128, 128, 64),
    (1, 8, 1, 100, 100, 64),   # MQA, ragged seq
    (1, 2, 2, 64, 192, 32),    # cross-length
    (1, 16, 8, 96, 96, 128),   # GQA group 2
])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_sweep_matches_jax(b, hq, hkv, sq, sk, dh, causal):
    q, k, v = _inputs(b, hq, hkv, sq, sk, dh)
    got = _port(q, k, v, causal=causal).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = ops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                 block_k=64, interpret=True)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=causal)
    assert np.abs(got - np.asarray(pallas)).max() < 2e-5
    assert np.abs(got - np.asarray(oracle)).max() < 2e-5


def test_flash_attention_bf16_matches_jax():
    q, k, v = _inputs(1, 4, 2, 128, 128, 64)
    got = _port(q, k, v, torch.bfloat16, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    pallas = ops.flash_attention(jq, jk, jv, causal=True, block_q=64,
                                 block_k=64, interpret=True)
    oracle = ref.flash_attention_ref(jq.astype(jnp.float32),
                                     jk.astype(jnp.float32),
                                     jv.astype(jnp.float32), causal=True)
    got = got.float().numpy()
    assert np.abs(got - np.asarray(oracle)).max() < 5e-2
    assert np.abs(got - np.asarray(pallas, np.float32)).max() < 5e-2


def test_flash_attention_decode_alignment_matches_jax():
    """One query against a long KV cache, causal offset."""
    q, k, v = _inputs(2, 4, 4, 1, 256, 64)
    got = _port(q, k, v, causal=True).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = ops.flash_attention(jq, jk, jv, causal=True, block_q=8,
                                 block_k=64, interpret=True)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=True)
    assert np.abs(got - np.asarray(pallas)).max() < 2e-5
    assert np.abs(got - np.asarray(oracle)).max() < 2e-5


def test_rows_without_visible_keys_are_zero():
    """Causal, sq > sk: rows t < sq - sk see no key.  The port returns 0
    there; the oracle gives NaN, and agrees with the port on every other
    row."""
    q, k, v = _inputs(1, 4, 2, 40, 25, 16)
    got = _port(q, k, v, causal=True).numpy()
    oracle = np.asarray(ref.flash_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True))
    assert np.all(got[:, :, :15] == 0.0)
    assert np.all(np.isnan(oracle[:, :, :15]))
    assert np.abs(got[:, :, 15:] - oracle[:, :, 15:]).max() < 2e-5


def test_explicit_scale_matches_jax():
    q, k, v = _inputs(1, 4, 2, 33, 33, 32)
    got = _port(q, k, v, causal=True, scale=0.3).numpy()
    want = ref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=True, scale=0.3)
    assert np.abs(got - np.asarray(want)).max() < 2e-5


@pytest.mark.parametrize("shapes,dtypes,err", [
    (((1, 4, 8, 16), (1, 3, 8, 16), (1, 3, 8, 16)), None, ValueError),
    (((1, 4, 8, 16), (1, 2, 8, 32), (1, 2, 8, 32)), None, ValueError),
    (((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 9, 16)), None, ValueError),
    (((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)),
     (torch.float32, torch.float64, torch.float64), TypeError),
])
def test_flash_attention_rejects_bad_inputs(shapes, dtypes, err):
    dtypes = dtypes or (torch.float32,) * 3
    q, k, v = (torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes))
    with pytest.raises(err):
        tfa.flash_attention(q, k, v)


def _tf32(x):
    """x rounded to TF32 (10 fraction bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds a finite x, and as the kernel's
    ``split_tf32`` does it: half a TF32 ulp added to the bits, the 13 low
    bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """x truncated to TF32: the 13 low bits cleared (``split_tf32``'s lo)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_product(eq, a, b, split=True):
    """The float32 kernel's product of float32 operands on the TF32 tensor
    cores: each split into hi = TF32(x) and lo = x - hi truncated to TF32,
    and lo hi + hi lo + hi hi summed in float32 (the products are exact);
    ``split=False`` is one TF32 pass, hi hi."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _f32_keys(dh):
    """Keys a K/V tile of the float32 kernel (F32Tile::kKeys)."""
    return 64 if dh <= 80 else 32


def _tile_emulation(q, k, v, *, causal, scale=None, split=True, rows=64,
                    keys=None):
    """The tensor-core kernels' arithmetic (csrc/flash_attention.cu) in
    plain PyTorch, one 64-row block and one tile of keys at a time.
    bfloat16 / float16 (flash_fwd_wgmma): 64-key tiles, P split into hi +
    lo in the input dtype; ``split=False`` rounds P to the input dtype once
    instead, as the TPU kernel does.  float32 (flash_fwd_tf32): the
    kernel's keys a tile, S = Q K^T and P V as three TF32 products of split
    operands (:func:`_tf32_product`); ``split=False`` is one TF32 pass.  A
    negative scale flips q here; the kernels flip q, or the float32 scores
    where q is staged in shared memory (dh = 256), both exact, so the
    scores are the same."""
    dtype = q.dtype
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    f32 = dtype == torch.float32
    if keys is None:
        keys = _f32_keys(dh) if f32 else 64
    scale_log2 = torch.tensor((1.0 / dh ** 0.5 if scale is None else scale)
                              * LOG2E, dtype=torch.float32)
    if scale_log2 < 0:  # the kernel flips q's sign and uses |scale_log2|
        q, scale_log2 = -q, -scale_log2
    kk = k.float().repeat_interleave(hq // hkv, dim=1)
    vv = v.float().repeat_interleave(hq // hkv, dim=1)
    out = torch.zeros(q.shape, dtype=dtype)
    shift = sk - sq
    for r0 in range(0, sq, rows):
        qt = q[:, :, r0:r0 + rows].float()
        row = torch.arange(r0, r0 + qt.shape[2])
        # the block stops at its last row's diagonal
        k_end = min(sk, r0 + qt.shape[2] + shift) if causal else sk
        lim = (row + shift + 1).clamp(max=sk) if causal \
            else torch.full_like(row, sk)
        m = torch.full(qt.shape[:3] + (1,), float("-inf"))
        l = torch.zeros(qt.shape[:3] + (1,))
        acc = torch.zeros(qt.shape)
        for k0 in range(0, max(k_end, 0), keys):
            key = torch.arange(k0, min(k0 + keys, sk))
            # raw scores; p = exp2((s - m) scale_log2), the difference first
            s = (_tf32_product("bhqd,bhkd->bhqk", qt, kk[:, :, key], split)
                 if f32 else
                 torch.einsum("bhqd,bhkd->bhqk", qt, kk[:, :, key]))
            s = s.masked_fill(key[None, :] >= lim[:, None], float("-inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            m_use = m_new.masked_fill(m_new == float("-inf"), 0.0)
            alpha = torch.where(m == float("-inf"), 0.0,
                                torch.exp2((m - m_use) * scale_log2))
            p = torch.where(s == float("-inf"), 0.0,
                            torch.exp2((s - m_use) * scale_log2))
            l = l * alpha + p.sum(-1, keepdim=True)
            if f32:
                acc = acc * alpha + _tf32_product(
                    "bhqk,bhkd->bhqd", p, vv[:, :, key], split)
            else:
                hi = p.to(dtype).float()
                acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", hi,
                                                 vv[:, :, key])
                if split:
                    acc = acc + torch.einsum("bhqk,bhkd->bhqd",
                                             (p - hi).to(dtype).float(),
                                             vv[:, :, key])
            m = m_new
        out[:, :, r0:r0 + rows] = torch.where(
            l > 0, acc / l.clamp(min=1e-30), 0.0).to(dtype)
    return out


def _limit_share(got, want, atol, rtol, extra=0.0):
    """Largest |got - want| / (atol + extra + rtol |want|): at most 1 when
    every element is within the limit."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + extra + rtol * want.abs()))
                 .max())


def _emulation_vs_jax_and_plain(dtype, b, hq, hkv, sq, sk, dh, causal,
                                rng=RNG):
    q, k, v = (torch.as_tensor(a).to(dtype)
               for a in _inputs(b, hq, hkv, sq, sk, dh, rng))
    got = _tile_emulation(q, k, v, causal=causal)
    plain = tfa.flash_attention_plain(q, k, v, causal=causal)
    atol, rtol = TWO_ULPS[dtype]
    assert _limit_share(got, plain, atol, rtol) <= 1.0
    jq, jk, jv = (jnp.asarray(t.float().numpy(), JNP[dtype])
                  for t in (q, k, v))
    pallas = torch.as_tensor(np.asarray(ops.flash_attention(
        jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True),
        np.float32))
    # the Pallas kernel's rows with keys
    seen = sq - max(0, sq - sk) if causal else sq
    assert _limit_share(got[:, :, sq - seen:], pallas[:, :, sq - seen:],
                        atol, rtol,
                        extra=UNIT[dtype] * float(v.float().abs().max())) \
        <= 1.0


@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh", [
    (1, 32, 8, 128, 128, 64),   # granite-3-2b heads
    (1, 32, 8, 100, 100, 64),   # granite, ragged 64-row block
    (2, 8, 1, 70, 70, 32),      # GQA group 8
    (1, 4, 4, 1, 256, 64),      # decode alignment
    (1, 4, 2, 65, 200, 128),    # ragged, sk > sq
    (1, 2, 1, 60, 24, 16),      # sk < sq: rows without keys
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tile_emulation_matches_jax_and_plain(dtype, b, hq, hkv, sq, sk, dh):
    """The emulated kernel within two ulps of the plain version, and
    against the Pallas kernel (interpret mode) within two ulps plus the
    Pallas kernel's own error: it rounds P to the input dtype once, which
    moves an output by at most u max|v| (u the unit roundoff)."""
    _emulation_vs_jax_and_plain(dtype, b, hq, hkv, sq, sk, dh, True)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh", [
    (1, 4, 4, 130, 130, 80),    # hubert's heads (MHA), ragged 64-row block
    (1, 4, 2, 65, 200, 80),     # GQA group 2, ragged, sk > sq
    (1, 8, 1, 100, 100, 256),   # paligemma-3b's 8:1, ragged
    (2, 4, 2, 70, 40, 256),     # sk < sq: causal rows without keys
])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tile_emulation_head_dims_80_and_256_match_jax_and_plain(
        dtype, causal, b, hq, hkv, sq, sk, dh):
    """dh 80 (hubert-xlarge) and 256 (gemma-7b, paligemma-3b) on the
    tensor cores: the same 64 rows and 64 keys a tile, causal and not,
    against the plain version and the Pallas kernel, with the limits of
    test_tile_emulation_matches_jax_and_plain.  Its own generator: the
    module's draws for the tests after it stay as they were."""
    _emulation_vs_jax_and_plain(dtype, b, hq, hkv, sq, sk, dh, causal,
                                np.random.default_rng(sq + sk + dh))


@pytest.mark.parametrize("scale", [0.05, -0.2, 0.0])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tile_emulation_explicit_scale_matches_plain(dtype, causal, scale):
    """A given scale, negative (the kernel flips q's sign) and 0 (every
    visible key weighs the same)."""
    q, k, v = (torch.as_tensor(a).to(dtype)
               for a in _inputs(1, 4, 2, 130, 130, 64))
    got = _tile_emulation(q, k, v, causal=causal, scale=scale)
    want = tfa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    assert _limit_share(got, want, *TWO_ULPS[dtype]) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_one_rounding_of_p_fails_the_two_ulp_limit(dtype):
    """Why the kernel splits P: at s = 2048 (causal, dh = 64), rounding P
    once to the input dtype puts outputs near zero many ulps off the
    float32 attention; hi + lo stays within two ulps."""
    q, k, v = (torch.as_tensor(a).to(dtype)
               for a in _inputs(1, 4, 1, 2048, 2048, 64))
    want = tfa.flash_attention_plain(q, k, v, causal=True)
    atol, rtol = TWO_ULPS[dtype]
    once = _tile_emulation(q, k, v, causal=True, split=False)
    split = _tile_emulation(q, k, v, causal=True)
    assert _limit_share(once, want, atol, rtol) > 2.0
    assert _limit_share(split, want, atol, rtol) <= 1.0


def test_time_flash_bounds_and_needs_a_card():
    """The timing script's bounds: operations at every path's heads
    (hubert's 16 x 4096 x dh 80 non-causal 85.9 GFLOP, 0.0869 ms at 989
    TFLOP/s; gemma's causal 16 x 2048 x dh 256 34.4 GFLOP, 0.0348 ms), and
    it refuses to run without a card."""
    from repro_torch.launch import time_flash
    ms, by, flops = time_flash.bound(*time_flash.SHAPES["hubert"])
    assert (by, flops) == ("operations", 4 * 16 * 80 * 4096 * 4096)
    assert abs(ms - 0.0869) < 5e-5
    ms, by, flops = time_flash.bound(*time_flash.SHAPES["gemma"])
    assert (by, flops) == ("operations", 4 * 16 * 256 * 2048 * 2049 // 2)
    assert abs(ms - 0.0348) < 5e-5
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            time_flash.main([])


# the float32 kernel's limit: the JAX kernel tests' 2e-5 absolute
F32_ATOL = 2e-5


def _f32_emulation_share(b, hq, hkv, sq, sk, dh, causal, seed, scale=None,
                         q_gain=1.0, split=True):
    """(share of 2e-5 against the JAX oracle, against the plain version)
    of the float32 kernel's emulation, over the rows that see a key (the
    oracle gives NaN on the others; the emulation's 0 there is checked
    against the plain version's 0)."""
    q, k, v = (torch.as_tensor(a) for a in
               _inputs(b, hq, hkv, sq, sk, dh, np.random.default_rng(seed)))
    q = q * q_gain
    got = _tile_emulation(q, k, v, causal=causal, scale=scale, split=split)
    plain = tfa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    oracle = torch.as_tensor(np.array(ref.flash_attention_ref(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal,
        **({} if scale is None else {"scale": scale}))))
    seen = sq - max(0, sq - sk) if causal else sq
    if seen < sq:
        assert bool((got[:, :, :sq - seen] == 0).all())
    return (_limit_share(got[:, :, sq - seen:], oracle[:, :, sq - seen:],
                         F32_ATOL, 0.0),
            _limit_share(got, plain, F32_ATOL, 0.0))


@pytest.mark.parametrize("b,hq,hkv,sq,sk", [
    (1, 4, 4, 130, 130),   # MHA, ragged 64-row block
    (2, 8, 2, 70, 70),     # GQA group 4
    (1, 4, 2, 65, 200),    # sk > sq: decode alignment, ragged
    (1, 2, 1, 1, 150),     # one query against a cache
    (1, 4, 2, 90, 40),     # sk < sq: causal rows without keys
])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", [16, 64, 80, 128, 256])
def test_tf32_split_emulation_matches_jax_and_plain(dh, causal, b, hq, hkv,
                                                    sq, sk):
    """The float32 kernel's arithmetic (TF32 hi/lo split, three products
    for S and for P V, its keys a tile) within 2e-5 of the JAX oracle and
    of the plain version at every head-dim class it is built for."""
    to_jax, to_plain = _f32_emulation_share(b, hq, hkv, sq, sk, dh, causal,
                                            sq + sk + dh)
    assert to_jax <= 1.0 and to_plain <= 1.0


@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("scale,q_gain", [(-0.2, 1.0), (0.05, 1.0),
                                          (0.0, 1.0), (None, 4.0)])
def test_tf32_split_emulation_scale_and_large_logits(dh, scale, q_gain):
    """A negative scale (the kernel flips q, or the scores at dh = 256), a
    zero scale (every visible key weighs the same) and large logits (q
    times 4: logits of ~4 standard deviations, where a logit's error moves
    the output most), within 2e-5 of the JAX oracle and the plain version.
    (At q times 6 and dh = 256 the plain version's own float32 sums are
    0.45-0.7 of the limit off the float64 attention on these inputs, and
    the emulation's ~1.1: float32 itself runs out there.)"""
    to_jax, to_plain = _f32_emulation_share(1, 4, 2, 100, 100, dh, True,
                                            dh + 7, scale=scale,
                                            q_gain=q_gain)
    assert to_jax <= 1.0 and to_plain <= 1.0


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """_tf32 keeps 10 fraction bits: 1 + 2^-11 (a tie) rounds away from
    zero to 1 + 2^-10, and so does -(1 + 2^-11); 1 + 2^-12 rounds to 1;
    hi + lo (lo = x - hi truncated to TF32) is x to 2^-21 |x|."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      1 + 2.0 ** -10 + 2.0 ** -13])
    hi = _tf32(x)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0,
                           1 + 2.0 ** -10]
    y = torch.as_tensor(RNG.normal(size=4096).astype(np.float32))
    hi = _tf32(y)
    lo = _tf32_trunc(y - hi)
    assert float(((y - hi).abs() / y.abs()).max()) <= 2.0 ** -11
    assert float(((y - hi - lo).abs() / y.abs()).max()) <= 2.0 ** -21


def test_one_tf32_pass_fails_the_float32_limit():
    """Why the float32 kernel splits: at granite-3-2b's heads (32 on 8,
    dh = 64, causal, s = 256), one TF32 pass for S and for P V puts outputs
    ~60 times 2e-5 off the JAX oracle; the split stays within 0.1 of it."""
    once, _ = _f32_emulation_share(1, 32, 8, 256, 256, 64, True, 64,
                                   split=False)
    split, _ = _f32_emulation_share(1, 32, 8, 256, 256, 64, True, 64)
    assert once > 10.0
    assert split <= 0.2


def test_time_flash_float32_bound_and_ceiling():
    """float32 runs at the TF32 dense peak (495 TFLOP/s): granite's heads at
    s = 2048, causal, are 17,188,257,792 FLOPs, 0.0347 ms of bound, and
    the three-product ceiling 0.1042 ms; bf16 stays at 989 TFLOP/s."""
    from repro_torch.launch import roofline, time_flash
    ms, by, flops = time_flash.bound(*time_flash.SHAPES["granite"],
                                     dtype="float32")
    assert (by, flops) == ("operations", 17_188_257_792)
    assert abs(ms - 0.0347) < 5e-5
    assert abs(roofline.tf32_split_ceiling_ms(flops) - 0.1042) < 5e-5
    bf16_ms, _, _ = time_flash.bound(*time_flash.SHAPES["granite"])
    assert abs(bf16_ms - 17_188_257_792 / 989e12 * 1e3) < 1e-9


def test_design_names_the_kernel_that_runs():
    assert tfa.design(torch.float32, 64) == "mma.sync tf32x3"
    assert {tfa.design(dt, dh) for dt in (torch.bfloat16, torch.float16)
            for dh in tfa.HEAD_DIMS} == {"wgmma"}
    with pytest.raises(ValueError):
        tfa.design(torch.float32, 48)
