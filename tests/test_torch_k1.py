"""Port parity for the entries of kernel K1 that fuse its multiply into a
larger step (`bazuka_tpu_torch.ops.field_kernel`), on the CPU, where each
wrapper runs its plain version:

- the NTT's stages, called at the kernel's interface (bit-reversed input,
  the packed stage twiddles; stages 0..k-1 on blocks of 2^k rows, then the
  single stages), equal `bazuka_tpu.ops.ntt.ntt_mont` (numpy backend at
  every size, jax backend at the smallest) and `ntt_host` at log_n 3-10,
  forward and inverse, with the kernel's k and a small one so both parts
  run; the in-place wrapper writes the same over its input;
- the stages over a batch of rows (the four-step's row transforms) equal
  the whole-array form run row by row and the JAX package's batched stage
  loop, and refuse a row length that is no power of two, a row longer
  than the array, or a table of another row length;
- the Fp inversion's plain version equals the JAX `fp_field("jax")
  .inv_mont` on 0, 1, p - 1 and random inputs, and `LimbField.inv_mont`
  takes it;
- both entries raise on a device that is neither the CPU nor CUDA, and a
  view that does not start on a 16-byte boundary is copied before a
  kernel would read it.
"""

import numpy as np
import pytest
import torch

from bazuka_tpu.fields.limbs import fp_field as j_fp
from bazuka_tpu.fields.limbs import fr_field as j_fr
from bazuka_tpu.ops import ntt as jn
from bazuka_tpu_torch.fields.limbs import fp_field, fr_field, to_numpy
from bazuka_tpu_torch.ops import field_kernel as fk
from bazuka_tpu_torch.ops import ntt as tn

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def rand_vals(p, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n)]


@pytest.mark.parametrize("log_n", range(3, 11))
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_ntt_stages_plain_matches_jax(log_n, inverse):
    F = fr_field()
    n = 1 << log_n
    vals = rand_vals(F.p, n, 100 * log_n + inverse)
    vals[1], vals[2] = 0, F.p - 1
    x = F.encode(vals, device="cpu")
    a = x[tn._rev(log_n, "cpu")]
    tw = tn._stage_twiddles(log_n, inverse, "cpu")
    n_inv = F.const_mont(pow(n, -1, F.p), "cpu")
    # the JAX package's transform on its numpy backend at every size (the
    # same stage loop; tests/test_torch_ntt.py compiles the jax backend at
    # log_n 4 and 8), and on the jax backend at the smallest
    wants = []
    for backend in ("np", "jax") if log_n == 3 else ("np",):
        Fj = j_fr(backend)
        wants.append(np.asarray(jn.ntt_mont(Fj.xp.asarray(Fj.encode(vals)),
                                            inverse, backend)))
    host = jn.ntt_host(vals, inverse)
    for low_log in (fk.NTT_LOW_LOG, 2):
        got = fk.ntt_stages_plain(a, tw, low_log)
        if inverse:
            got = fk.mont_mul_plain(F, got, n_inv)
        for want in wants:
            assert np.array_equal(to_numpy(got), want), low_log
        assert [int(v) for v in F.decode(got)] == host
    before = a.clone()
    same = fk.ntt_stages_(a, tw)
    assert same is a
    assert torch.equal(a, fk.ntt_stages_plain(before, tw))


@pytest.mark.parametrize("log_m, low_log", [(3, 10), (5, 2), (6, 10)])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_ntt_stages_over_rows(log_m, low_log, inverse):
    F, Fj = fr_field(), j_fr("np")
    rows, m = 4, 1 << log_m
    vals = rand_vals(F.p, rows * m, 40 + log_m + inverse)
    vals[0], vals[m + 1] = 0, F.p - 1
    x = F.encode(vals, device="cpu").view(rows, m, F.n)
    a = x[:, tn._rev(log_m, "cpu")].reshape(rows * m, F.n)
    tw = tn._stage_twiddles(log_m, inverse, "cpu")
    got = fk.ntt_stages_plain(a, tw, low_log, row=m)
    each = [fk.ntt_stages_plain(a[i * m:(i + 1) * m], tw, low_log)
            for i in range(rows)]
    assert torch.equal(got, torch.cat(each))
    want = jn._ntt_batched_fn(log_m, inverse, "np", scale=False)(
        Fj.encode(vals).reshape(rows, m, Fj.n), jn._rev_dev(log_m, "np"),
        jn._stage_twiddles(log_m, inverse, "np"))
    assert np.array_equal(to_numpy(got), np.asarray(want).reshape(-1, F.n))
    same = a.clone()
    assert fk.ntt_stages_(same, tw, row=m) is same
    assert torch.equal(same, got)
    # row = 0 and row = n are one row of n
    assert torch.equal(fk.ntt_stages_plain(a[:m], tw, row=m),
                       fk.ntt_stages_plain(a[:m], tw, row=0))


def test_ntt_stages_refuse_bad_rows():
    F = fr_field()
    a = F.encode(rand_vals(F.p, 16, 9), device="cpu")
    with pytest.raises(ValueError):
        fk.ntt_stages_plain(a, tn._stage_twiddles(2, False, "cpu"), row=3)
    with pytest.raises(ValueError):
        fk.ntt_stages_plain(a, tn._stage_twiddles(5, False, "cpu"), row=32)
    with pytest.raises(ValueError):  # a table of another row length
        fk.ntt_stages_(a.to("meta"), tn._stage_twiddles(3, False, "cpu")
                       .to("meta"), row=4)


def test_ntt_mont_runs_the_stage_entry():
    """ntt_mont is the gather, the stage entry and the n^-1 scale."""
    F = fr_field()
    x = F.encode(rand_vals(F.p, 64, 3), device="cpu")
    tw = tn._stage_twiddles(6, True, "cpu")
    want = fk.mont_mul_plain(F, fk.ntt_stages_plain(x[tn._rev(6, "cpu")],
                                                    tw),
                             F.const_mont(pow(64, -1, F.p), "cpu"))
    assert torch.equal(tn.ntt_mont(x, True), want)


def test_inversion_plain_matches_jax():
    F = fp_field()
    vals = [0, 1, F.p - 1] + rand_vals(F.p, 9, 4)
    x = F.encode(vals, device="cpu")
    got = fk.mont_inv_plain(F, x)
    Fj = j_fp("jax")
    want = np.asarray(Fj.inv_mont(Fj.xp.asarray(Fj.encode(vals))))
    assert np.array_equal(to_numpy(got), want)
    assert torch.equal(F.inv_mont(x), got)
    assert torch.equal(fk.mont_inv(F, x), got)
    assert [int(v) for v in F.decode(got)] == [
        pow(v, -1, F.p) if v else 0 for v in vals]  # 0 maps to 0


def test_entries_raise_on_other_devices():
    F = fr_field()
    a = F.encode(rand_vals(F.p, 8, 5), device="cpu")
    tw = tn._stage_twiddles(3, False, "cpu")
    with pytest.raises(ValueError):
        fk.ntt_stages_(a.to("meta"), tw.to("meta"))
    with pytest.raises(ValueError):
        fk.ntt_stages_(a, tw.to("meta"))  # operands on two devices
    Fp = fp_field()
    b = Fp.encode([1, 2, 3], device="cpu").to("meta")
    with pytest.raises(ValueError):
        fk.mont_inv(Fp, b)
    with pytest.raises(ValueError):
        Fp.inv_mont(b)


def test_misaligned_views_are_copied():
    F = fp_field()
    base = F.encode(rand_vals(F.p, 4, 6), device="cpu").clone()
    flat = torch.cat([torch.zeros(1, dtype=torch.int32), base.reshape(-1)])
    view = flat[1:].view(4, F.n)  # starts 4 bytes into its storage
    assert view.data_ptr() % 16 == 4
    fixed = fk._aligned(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, base)
    assert fk._aligned(base) is base
    strided = torch.stack([base, base], dim=1)[:, 1]
    assert not strided.is_contiguous()
    out = fk._aligned(strided)
    assert out.is_contiguous() and torch.equal(out, base)
