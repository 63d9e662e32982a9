"""`kernel_ab.py`, the harness that times the curve-add kernels against
other checkouts on the card, in its parts that run without one.

- Its table of kernels names K2-K5 of `_cuda.REGISTRY`, with the planes
  and multiplies that `chip_smoke.py` replays them with, and its table of
  full adds K6/K7 with their C symbols, at keygen's lane counts.
- Its probe includes only headers of `_cuda.HEADERS`.
- Its lane counts include the run-merge scan's 180,224, and its masks the
  merge scan's, a quarter of the lanes active in contiguous blocks.
- It loads a checkout's `_cuda.py` on its own, and that module builds from
  the checkout's own sources.
- It reads registers, spills and stack from a `-Xptxas -v` log.
- K1's entries run at the 2^22 proof's sizes, and a checkout without the
  NTT's stage entry or the inversion runs what its prover ran instead:
  the stand-in stage loop and `pow_mont`'s chain on a multiply equal the
  plain versions, with b's rows handed to the multiply as the wrapper
  hands them.
- Without a CUDA device it exits 2 and prints no result.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

import kernel_ab
from bazuka_tpu_torch.fields.limbs import fp_field, fr_field
from bazuka_tpu_torch.ops import _cuda
from bazuka_tpu_torch.ops import curve_kernels as ck
from bazuka_tpu_torch.ops import field_kernel as fk
from bazuka_tpu_torch.ops import ntt as tn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_Z6kernelPi' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPi
    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 0 barriers, 368 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherPi' for 'sm_90a'
ptxas info    : Function properties for _Z5otherPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 1024 bytes smem, 368 bytes cmem[0]
"""


def test_select_kernels_are_k2_to_k5():
    specs = kernel_ab.select_kernels()
    assert set(specs) == {ck.K_G1_MADD.name, ck.K_G1_ADD.name,
                          ck.K_G2_MADD.name, ck.K_G2_ADD.name}
    assert specs[ck.K_G1_MADD.name][1:] == (3, 2, 11)
    assert specs[ck.K_G2_ADD.name][1:] == (6, 6, 36)
    for name in specs:
        assert _cuda.REGISTRY[name].n_ptrs == 4


def test_full_add_kernels_are_k6_and_k7():
    specs = kernel_ab.full_add_kernels()
    assert set(specs) == {ck.K_G1_FULL.name, ck.K_G2_FULL.name}
    assert specs[ck.K_G1_FULL.name] == (ck.g1_add_lm_plain, 3, 12)
    assert specs[ck.K_G2_FULL.name] == (ck.g2_add_lm_plain, 6, 36)
    assert ck.K_G1_FULL.symbol == "bz_g1_add"
    assert ck.K_G2_FULL.symbol == "bz_g2_add"
    for name in specs:
        kern = _cuda.REGISTRY[name]
        assert kern.n_ptrs == 3 and kern.source == "add_select.cu"
    assert {65_536, 65_535} <= set(kernel_ab.FULL_LANES)


def test_probe_includes_only_hashed_headers():
    includes = re.findall(r'#include "([^"]+)"', kernel_ab.PROBE)
    assert includes and set(includes) <= set(_cuda.HEADERS)


def test_loads_a_checkouts_cuda_module():
    mod = kernel_ab.load_cuda_module("self", ROOT)
    assert mod is not _cuda
    assert mod.SOURCES == _cuda.SOURCES
    assert mod.CSRC == _cuda.CSRC
    assert mod.lib_path("add_select.cu") == _cuda.lib_path("add_select.cu")
    assert mod.REGISTRY == {}


def test_masks_at_the_merge_scans_lane_count():
    L = 180_224  # R_cap of the 2^22 proof's run-merge scan: 22 windows
    assert L in kernel_ab.LANES
    gen = torch.Generator()
    gen.manual_seed(3)
    masks = kernel_ab.masks(L, gen, "cpu")
    assert set(masks) == {"replay", "drain", "merge", "full"}
    for m in masks.values():
        assert m.dtype == torch.bool and tuple(m.shape) == (L,)
        assert m.is_contiguous()
    merge = masks["merge"]
    assert abs(float(merge.float().mean()) - 0.25) < 0.01
    # contiguous blocks of 2,048 active lanes, one per 8,192
    assert bool(merge[:2048].all()) and not bool(merge[2048:8192].any())
    assert int(merge.view(-1, 8192).sum(1).min()) == 2048


def test_reads_ptxas_log():
    rows = kernel_ab.ptxas_kernels(PTXAS_LOG)
    assert rows == [
        {"function": "_Z6kernelPi", "stack_frame": 16, "spill_stores": 16,
         "registers": 168, "smem": 0},
        {"function": "_Z5otherPi", "stack_frame": 0, "spill_stores": 0,
         "registers": 40, "smem": 1024},
    ]


def test_k1_sizes_are_the_proofs():
    assert ("Fr", 1 << 22, 1 << 22) in kernel_ab.K1_MUL
    assert ("Fr", 1 << 21, 1 << 21) in kernel_ab.K1_MUL
    assert ("Fp", 1 << 16, 1 << 16) in kernel_ab.K1_MUL
    assert kernel_ab.K1_NTT == (1 << 22, 1 << 21)
    assert kernel_ab.K1_INV == (1, 1 << 16)
    assert set(kernel_ab.K1_NEW) == {fk.K_NTT.symbol, fk.K_INV.symbol}


def _plain_call(F, seen):
    """A stand-in for a multiply entry's ctypes call: the plain product of
    a's rows against b's rows repeated, as the kernel reads them."""
    def call(a, b, out, n, rows):
        seen.append((n, rows))
        prod = fk.mont_mul_plain(F, a.reshape(n // rows, rows, F.n),
                                 b.reshape(rows, F.n))
        out.copy_(prod.reshape(out.shape))
    return call


def test_stand_ins_equal_the_plain_versions():
    F = fr_field()
    gen = torch.Generator()
    gen.manual_seed(2)
    x, tw = kernel_ab.cs.ntt_operands(32, gen, "cpu")
    seen = []
    mul = kernel_ab.mul_with(F, _plain_call(F, seen))
    got = kernel_ab.stage_loop(mul, x, tw)
    assert torch.equal(got, fk.ntt_stages_plain(x, tw))
    # stage s multiplies n/2 elements against its 2^s twiddle rows
    assert seen == [(16, 1 << s) for s in range(5)]
    Fp = fp_field()
    z = kernel_ab.cs.inv_operands(3, gen, "cpu")
    inv = Fp.pow_mont(z, Fp.p - 2,
                      mul=kernel_ab.mul_with(Fp, _plain_call(Fp, [])))
    assert torch.equal(inv, fk.mont_inv_plain(Fp, z))


def test_exits_2_without_cuda():
    res = subprocess.run([sys.executable, "kernel_ab.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 2
    assert '"ok"' not in res.stdout
