#!/usr/bin/env python3
"""Run the PyTorch + CUDA port (`bazuka_tpu_torch`) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py              # d = Np = 2^22 (the default)
    python3 chip_smoke.py --log-d 20   # smaller synthetic proof and key,
                                       # MPN batches of 4 transfers (the
                                       # mainnet one with the big-mode
                                       # thresholds lowered), and smaller
                                       # phases 7-8

Phases, each printed as one JSON line:
  1. device   card name and power limit (nvidia-smi), torch and CUDA versions
  2. build    nvcc builds every kernel from `bazuka_tpu_torch/csrc/`
  3. toy      the committed toy key (tests/data/toy_multiply_params.npz),
              2-constraint multiply circuit at r = 7, s = 11: the proof's
              wire bytes equal the JAX package's (pinned below), and
              groth16_verify accepts [z] and rejects [z+1] and [z, 0]
  4. proof    one `create_proof` at d = Np = 2^22 on a synthetic circuit of
              the MPN batch-64 update proof's size (3,275,554 constraints:
              half boolean wires, half a multiply chain)
              and a key whose every point has a known discrete log: A, B, C
              equal the points computed on the host from scalars alone, and
              h(x) satisfies a(ρ)·b(ρ) − c(ρ) = h(ρ)·Z(ρ) at a random ρ, with
              a(ρ), b(ρ), c(ρ) summed over the circuit's own terms
              (barycentric Lagrange basis; neither the port's row plans nor
              its NTT).  The kernels' launch counts and sizes are recorded;
              K1's four entries (the Fr and Fp multiplies, the NTT's
              stages, the Fp inversion) and K2-K5 must each have run.
              Then `msm_a` and `msm_b_g2` once
              more, timed alone and under torch.profiler (`drain_profile`
              lines: device time by kernel, device idle share), and the h
              phase the same way, without the dedup-plan thread and after
              a run that rebuilds its NTT tables (`h_profile`)
  5. keygen   `generate_parameters` on the card: the key of the same
              synthetic MPN-b64-sized circuit at d = Np = 2^22, from a cold
              start (its launch counts and sizes are recorded; K6, K7, K1's
              multiplies and its Fp inversion must each have run), with 16
              rows of each query (first and
              last valid row, a pad row) and every VK point equal to the
              generator times a scalar recomputed on the host from the
              circuit's own terms, and a proof under that key that
              groth16_verify accepts for [x] and rejects for [x + 1]; then
              the toy multiply circuit at seed b"test", which must equal the
              committed key (all ten query arrays, the head points, the VK's
              wire bytes).  Then one `_gen_mul_am` chunk of 65,536 scalars
              on G1 and one on G2 under torch.profiler (`gen_mul_profile`
              lines: device time by kernel, the rest by PyTorch kernel
              name, idle share)
  6. mpn      MPN update proofs, the system's real workload, on the port's
              own host copies of the MPN state tree, witness generators and
              circuits, in two cells (`cell`), each with its host half in a
              worker process of its own started before phase 2: the witness
              and synthesis beside phases 2-5 and 7, the satisfaction check
              beside the cell's key (the host's MemTotal and the worker's
              peak RSS are printed).  First `mpn_b64`, the batch of 64
              transfers at d = Np = 2^22 in the prover's normal mode
              (3,275,554 constraints, 3,266,407 variables and the public
              inputs pinned to the JAX package's): its key on the card
              (seed b"mpn-update-b64", every query narrow on the card) and
              two proofs under it (7, 11 and 8, 12), each verified and
              rejected with next_state + 1, and the same profiles as
              below; then the `sharded` phase under its key: the sharded
              prover of `bazuka_tpu_torch/parallel/` with four shards on
              the card (a correctness gate; they run in turn): first
              `ntt_four_step` over the four shards at 2^22 and 2^24
              random limbs, forward and inverse, cold and warm, limb for
              limb against `ops.ntt.ntt_mont` (`sharded_fourstep`); then
              `create_proof_sharded` of the batch at 7, 11, its queries
              narrow on the card, and again with them on the host: each
              proof's bytes equal the cell's first proof, verified and
              rejected with next_state + 1, stage and upload seconds,
              peaks, launches (K1's multiplies, stage entry and Fp
              inversion and K2-K5 must each have run; the tree reduce
              of the shards' window sums is K3/K5 at 44 and 22 lanes).
              Then `mpn_b256`, the mainnet proof (the batch-256
              update circuit, d = Np = 2^24): 256 users (seeds
              b"U0".."U255") each deposit 1,000 of token 123 into a fresh
              MpnConfig(15, 1, 4, 4, 4, 0xBEEF) state, then user i pays
              user i + 1 (mod 256) 100 with a fee of 7 (`witness_gen`);
              the update circuit of that batch is synthesised
              (`synthesis`: 13,101,154 constraints, 13,064,551 variables,
              both pinned) and checked on the host (`satisfied_check`);
              its public inputs equal the JAX package's (pinned below).
              Then its key
              on the card (seed b"mpn-update-b256") under the default
              residency, the queries on the host at Np = 2^24 (K6, K7, K1's
              multiplies and its Fp inversion must each have run); saved
              in the directory layout to a temporary directory (seconds,
              bytes on disk) and loaded back memory-mapped, head and VK
              equal to the generated key's; a proof under the loaded key
              (r, s = 7, 11; host-resident, big mode: the four-step NTT,
              the narrow uploads and the half-split G2 MSM; K1's four
              entries, the four-step's row stages and K2-K5 must each have
              run), then one under the same directory loaded with every
              query narrow on the card (8, 12), each accepted by
              groth16_verify for the public inputs and rejected with
              next_state + 1, with stage and upload seconds, the device's
              peaks and the host's peak RSS; then the h phase
              (`h_profile`) and `msm_a` and the half-split `msm_b_g2`
              (`drain_profile`) of this witness under torch.profiler,
              "cell": "mpn_b256"; the directory is deleted
  7. poseidon (run before phase 6, while its worker finishes)
              the batched Poseidon of `ops/poseidon.py` on the card (every
              multiply a launch of K1 Fr, which must have run), at stress
              sizes (no caller hashes batches on the card yet): the 16
              golden vectors (arity 1-16); a dense 4-ary tree of 4^9
              random leaves hashed level by level (9 calls, 87,381
              arity-4 hashes), checked limb for limb against the same hash
              with K1's plain multiply on the card on the bottom level's
              first 1,024 hashes and every level of 4,096 or fewer, and
              on 256 random bottom-level hashes and one leaf's whole path
              to the root against the host Poseidon; one batch of 2^20
              arity-4 hashes, 256 random ones against the host; hashes/s
              of the tree and the batch beside the bound of the card's
              IMAD rate, peaks, K1's launch sizes; then the batch under
              torch.profiler (`poseidon_profile`)
  8. eddsa    JubJub EdDSA of `ops/jubjub_batch.py` on the card (K1 Fr
              must have run): one mainnet block, phase 6's 256 MPN
              transfers (users b"U0".."U255"), in one `batch_eddsa_verify`
              call, all valid: seconds per block and verifies/s beside the
              bound, the headline; then a stress size, 4,096 keys and
              signatures
              made on the host (seeds b"E0".., in four worker processes),
              every 8th row tampered with in turn (message + 1, s + 1,
              another signer's key, R moved along the curve, R off the
              curve), verified in one call; `batch_base_mul` and
              `batch_scalar_mul` alone on 4,096 scalars (0, 1, ORDER − 1
              and ORDER among them); the block's verification under
              torch.profiler (`eddsa_profile`); the block over two shards
              on the card, every 8th message + 1
              (`parallel.eddsa_verify_sharded`), the verdicts those of
              the construction; then the same three calls
              on CPU copies of the first 256 rows (the plain path, in
              three of the workers), equal, while the verdicts are held to
              those of the construction and the host JubJub.verify's on
              every tampered row and 256 random valid ones, and the
              products to the host point_mul on the four edge rows and
              256 random ones; peak, K1's launch sizes.  Below
              --log-d 22 both cells of phase 6 prove 4 transfers (d =
              2^18), `mpn_b256` with BIG_DOMAIN, the four-step's threshold
              and chunk and the residency thresholds lowered (each
              printed), so that the mainnet path runs, the `sharded`
              four-step runs at 2^16 and 2^18, and phases 7 and 8 run at
              4^6 leaves, 2^16 batch hashes and 256 signatures
  9. devchain the node's block production (bazuka_tpu/node/heartbeat.py:
              248-276, without the network) on the --dev chain of the
              port's `config/blockchain.py`: `get_dev_blockchain_config`
              at mainnet's tree shapes (log4_tree 15, log4_token_tree 3)
              and batches of 4 (mainnet's: 64 / 64 / 256) keys the
              deposit, withdraw and update circuits on the card (K1, K6,
              K7 must have run; synthesis and key seconds, constraints,
              d and launches of each key, every VK point on the curve
              and in the subgroup); a `KvStoreChain` over a `RamKvStore`
              on that config, users b"D0".."D2" funded on L1 and the
              validator b"DEV-VALIDATOR" registered; block 1: each user
              deposits 1,000 Ziesha; block 2: user i pays user i + 1
              (mod 3) 100 with a fee of 7 and D0-D1 withdraw 50 each
              to L1; the validator's reward self-deposit rides each
              deposit batch, the rewards are the node's (5 / 5 / 15 % of
              the validator's); per block `prepare_works` gives three
              works, each proven on the card under its key (K1's four
              entries and K2-K5 must have run) by the worker b"WORKER"
              and accepted by `pool.prove` (`MpnWork.verify`), while
              the proof with A negated is refused; `ready`, `draft_block`
              and `apply_block`, and the block with the update's proof
              negated (signed again) refused by `apply_block` on a fork
              with IncorrectZkProof; after block 2 the users' MPN and L1
              balances, the validator's MPN balance, the worker's
              rewards and the contract's height are those of the
              construction, and each block's `db_checksum` equals a
              second chain's, built on the three VKs passed through
              `zk/wire.py`, that applies the same blocks
 10. node     the node itself (bazuka_tpu_torch/node/), two of its
              nodes on the `devchain` phase's config with `check_validator`
              on (the peer checks the block's VRF proof, as on mainnet),
              wired through the port's `Simulation`, with the simulator's
              heartbeats and automatic block generation: the validator,
              its chain on a `DiskKvStore` in a temporary directory (as
              `cli node start` opens it) and its wallets from a
              `WalletCollection` of a pinned mnemonic saved to a wallet
              file and opened from it, and a peer on a `RamKvStore`; both
              chains set up as the `devchain` phase's (users b"D0".."D2"
              funded, the validator registered) and the validator's
              self-delegation, so that the VRF elects it; both clocks
              skewed alike so that the nodes start NODE_LEAD_S seconds
              before a slot.  The validator is also served over HTTP on
              127.0.0.1 (`serve_http`), and the worker b"WORKER" talks to
              it over real sockets (`http_sender`): it registers
              (`POST /bincode/mpn/worker`), sends the users' block-1
              deposits (`BazukaClient.transact`) before the validator's
              claim of the slot, asks for work (`GET /bincode/mpn/work`;
              its public inputs must equal the pool's; the pool hands a
              worker two works, so the third it takes from the pool in
              process, as it takes every work's transitions), proves each
              of the three works on the card under the `devchain` key of
              its kind (K1's four entries and K2-K5 must have run), and
              posts the proofs (`POST /bincode/mpn/solution`), the first
              with A negated, answered "accepted": 0.  The validator's
              heartbeat makes the block (`ready`, `try_produce`,
              `promote_block`) and the peer syncs it: both at height 2,
              the disk chain's `db_checksum` (again after reopening the
              file) equal to the peer's, the users' MPN and L1 balances,
              the validator's, the worker's rewards and the contract's
              height those of the construction, `GET /explorer/blocks`
              rendering the block; seconds from the deposits to the pool,
              per work, from the last solution to the block and from the
              block to the peer's sync; a wait past its deadline raises
 11. kernel   each kernel replayed at every size phases 4-10 (the
              `sharded` runs included) launched it with (the NTT's stages also over rows of 2^11 and 2^12 of
              2^23 and 2^24 elements), on fresh random operands (plus the edge cases: 0 and
              p − 1 among K1's operands and the NTT's inputs, R − 1 in one
              of K1's operands against a canonical other, 0, 1 and
              p − 1 among the inversion's; for the curve adds K2-K7 also
              active lanes of p − 1 and 0 in every coordinate, Z2
              included; K6/K7 always also at 65,535 and 65,536 lanes),
              against its plain PyTorch
              version: bit-identical limbs, its time, the plain version's
              time and the card's bound, per size and averaged over the
              phases' launches (the inversion's sizes against one plain
              call over all their operands, whose time each row reports)
Then the `mpn_launch_weighted` line (the replayed times weighted by the
mainnet key's and first proof's launches), the `launch_weighted` line (K1 Fr
weighted by phase 7's and phase 8's launches), the `{"kernels": [...]}`
line
(launch counts of the phases that ran each kernel, by phase, "sharded"
the `sharded` phase's and phase 8's sharded call's, "node" the worker's
three proofs in phase 10, and in all, times
averaged over their launches) and the last line
`{"ok": true, "device": {...}}`, after a `timeline` line of each phase's
seconds.  Any failed check raises, so the script
exits non-zero and prints no result.  Without a CUDA device it exits with
code 2.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import copy
import dataclasses
import functools
import json
import multiprocessing
import os
import resource
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from bazuka_tpu_torch.blockchain import KvStoreChain
from bazuka_tpu_torch.blockchain import error as chain_errors
from bazuka_tpu_torch.blockchain.chain import prover_commitment
from bazuka_tpu_torch.client import BazukaClient, PeerAddress, to_hex
from bazuka_tpu_torch.config.blockchain import get_dev_blockchain_config
from bazuka_tpu_torch.core.blocks import Block
from bazuka_tpu_torch.core.money import Ratio
from bazuka_tpu_torch.core.transaction import ContractId, Money
from bazuka_tpu_torch.crypto import bls12_381 as bls
from bazuka_tpu_torch.crypto import jubjub as jj
from bazuka_tpu_torch.db import DiskKvStore, Put, RamKvStore, keys as db_keys
from bazuka_tpu_torch.fields.host import FR_GENERATOR, FR_MODULUS
from bazuka_tpu_torch.fields.limbs import (
    FP_LIMBS,
    FR_LIMBS,
    fp_field,
    fr_field,
    int_to_limbs,
    ints_to_array,
    to_torch,
)
from bazuka_tpu_torch.groth16 import keygen, prove, qap
from bazuka_tpu_torch.groth16.r1cs import (
    ONE,
    CompiledR1CS,
    ConstraintSystem,
    lc,
)
from bazuka_tpu_torch.groth16.verify import groth16_verify
from bazuka_tpu_torch.mpn.chain_view import MpnChainView
from bazuka_tpu_torch.mpn.circuits import (
    DepositCircuit,
    UpdateCircuit,
    WithdrawCircuit,
    synthesize_circuit,
)
from bazuka_tpu_torch.mpn.config import MpnConfig
from bazuka_tpu_torch.mpn.deposit import deposit
from bazuka_tpu_torch.mpn.transitions import (
    DepositTransition,
    UpdateTransition,
    WithdrawTransition,
)
from bazuka_tpu_torch.mpn.update import update
from bazuka_tpu_torch.mpn.workpool import MpnWorker, prepare_works
from bazuka_tpu_torch.node import (
    get_simulator_options,
    http_sender,
    node_create,
    serve_http,
)
from bazuka_tpu_torch.node.simulation import Simulation, catch_change
from bazuka_tpu_torch import parallel
from bazuka_tpu_torch.ops import _cuda
from bazuka_tpu_torch.ops import curve_kernels as ck
from bazuka_tpu_torch.ops import field_kernel as fk
from bazuka_tpu_torch.ops.jubjub_batch import (
    batch_base_mul,
    batch_eddsa_verify,
    batch_scalar_mul,
    to_affine_host,
    to_extended,
)
from bazuka_tpu_torch.ops import msm_lm
from bazuka_tpu_torch.ops import ntt as ntt_mod
from bazuka_tpu_torch.ops.poseidon import poseidon_batch, poseidon_batch_mont
from bazuka_tpu_torch.ops import weierstrass as wst
from bazuka_tpu_torch.utils import ser
from bazuka_tpu_torch.utils.logging import GLOBAL_LOGS as LOG_LINES
from bazuka_tpu_torch.wallet import Mnemonic, WalletCollection
from bazuka_tpu_torch.wallet.tx_builder import TxBuilder
from bazuka_tpu_torch.zk.poseidon_host import params_for_width, poseidon
from bazuka_tpu_torch.zk.proof import (
    G1Wire,
    Groth16VerifyingKey,
    ZkProof,
    ZkVerifierKey,
)
from bazuka_tpu_torch.zk.state import ZkCompressedState, ZkContract
from bazuka_tpu_torch.zk.wire import decode_vk, encode_vk, validate_vk_points

P = FR_MODULUS
R_ORDER = bls.R
ROOT = os.path.dirname(os.path.abspath(__file__))
TOY_KEY = os.path.join(ROOT, "tests", "data", "toy_multiply_params.npz")

# Wire bytes of bazuka_tpu's proof of the toy multiply circuit (x = 3,
# y = 5) under the committed key at r = 7, s = 11;
# tests/test_torch_prove.py holds this constant against a live JAX proof.
TOY_PROOF_HEX = (
    "080f5cda6540f4a3dc5d5a6af40012bc5026ef149437f06b5085bdacfe2e3677"
    "7f14e4ff22fc5b58a57134faab11d118a83b7b2036d0984a30daf9f33760278a"
    "5f52f37de71e453f102f1b316c2e641bcd78079feaa4fc2e99f2647743c72609"
    "00de611bbf1c2251707b8371d8df9b6361fa40f382e33ec6ffb24610e2651fd8"
    "0dbad5ae401a305f1e04036ef710a5e419de0629e240e6cb1ce3879795700879"
    "a0d2435e5768c256d64ffa8c3463753ae9022290c4096db1e21b2d94dc4388e7"
    "149c267f1c27cb22cd5504368dce773a2625d64804d517a346f6d03c6e49a6fc"
    "053d3bba4caa94a6f96d048913800f440ecd6c77686a6c00795b3aabde51fa06"
    "e561cc1a17e38da28f2aadcd55870b246b10ade337afbe943cbe74d1c82a8a26"
    "0700ae22c54cbccfc8e5c90333d88af961435061cdc8741b53c55b7194626ce3"
    "6f782193e00cefceaea0606ff3db313fbe0dbb0aa911388417da003af63cee9f"
    "d8e93d3e7a4396bbc8e6c09a4ce36a3a008d3e8a2a81d08436651ae8fa2dbea5"
    "361800"
)

# seeds the synthetic circuit, its key and the evaluation point ρ
ROOT_SEED = 22

# The mainnet MPN update proof (phase 6's `mpn_b256` cell): the batch of
# 256 transfers (bazuka_tpu/config/blockchain.py:
# MPN_LOG4_UPDATE_BATCH_SIZE = 4) at MpnConfig(15, 1, 4, 4, 4, 0xBEEF),
# 256 users, deposits of 1,000 of token 123, then transfers of 100 with a
# fee of 7 in the same token; the prover's commitment is that of
# TxBuilder(b"WORKER") at reward 10.  Its circuit has 13,101,154
# constraints and 13,064,551 variables (d = 2^24), as the JAX package
# gives them (PERFORMANCE.md:163).
MPN_LOG4_TREE, MPN_LOG4_TOKEN_TREE, MPN_LOG4_BATCH = 15, 1, 4
MPN_CID, MPN_TOKEN = ContractId(0xBEEF), ContractId(123)
MPN_B256_CONSTRAINTS = 13_101_154
MPN_B256_VARS = 13_064_551
MPN_KEY_SEED = b"mpn-update-b256"
# The same batch of 64 transfers (the `mpn_b64` cell, log4_batch 3, d =
# 2^22, the prover's normal mode): 3,275,554 constraints (also the
# synthetic cell's size) and 3,266,407 variables.
MPN_B64_LOG4_BATCH = 3
MPN_B64_CONSTRAINTS = 3_275_554
MPN_B64_VARS = 3_266_407
MPN_B64_KEY_SEED = b"mpn-update-b64"
# [commitment, height, state, aux_data, next_state] of each batch from the
# JAX package's witness generators; tests/test_torch_mpn_circuits.py holds
# these constants against a live JAX run.
MPN_B64_PUBLIC_INPUTS = (
    425793916294024866280688143094958353768386253943388615763977799487240200991,
    0,
    46308135386502640685265267936454870375020195613555998958516818431280587886895,
    11005667598277283744753787204972477415047986931984279515100439540866077439515,
    8327045856812542320615866613050291403712736401878003321554717267399609843706,
)
MPN_B256_PUBLIC_INPUTS = (
    425793916294024866280688143094958353768386253943388615763977799487240200991,
    0,
    47854149401799016754183620629910736396196117106815656404314820227406456579629,
    2758243653281587398302229622205262935509536358022681555643839507108148284913,
    18901024506065832730375330085225562898243194160268116602994339232885748973027,
)
# Phase 6's cells: log4_batch, pinned constraints, variables and public
# inputs, key seed, and whether it is the mainnet cell (its proofs in big
# mode, its key saved, reloaded and proven under again with every query on
# the card).  `mpn_b64` runs first.
MPN_CELLS = {
    "mpn_b64": (MPN_B64_LOG4_BATCH, MPN_B64_CONSTRAINTS, MPN_B64_VARS,
                MPN_B64_PUBLIC_INPUTS, MPN_B64_KEY_SEED, False),
    "mpn_b256": (MPN_LOG4_BATCH, MPN_B256_CONSTRAINTS, MPN_B256_VARS,
                 MPN_B256_PUBLIC_INPUTS, MPN_KEY_SEED, True),
}
# Below --log-d 22 both cells prove 4 transfers (d = 2^18): `mpn_b64` in
# normal mode, then `mpn_b256` with these thresholds lowered, on the
# mainnet cell's path: big mode, the four-step NTT over several chunks,
# every query on the host.
SMALL_BIG_MODE = {"prove.BIG_DOMAIN": 1 << 18,
                  "ntt._FOURSTEP_MIN_LOG_N": 18,
                  "ntt._FOURSTEP_CHUNK_LANES": 1 << 16,
                  "keygen.RESIDENT_ALL_MAX": 1 << 16,
                  "keygen.RESIDENT_G1_MAX": 1 << 17}

# Phase 7 (poseidon): poseidon([0..arity-1]) for arity 1..16, the
# reference's golden vectors (src/zk/poseidon/mod.rs:115-149);
# tests/test_torch_poseidon.py holds them to tests/test_poseidon.py's.
POSEIDON_GOLDEN = (
    27570695323925995271701303589514430472678239829854264417883970952440292573348,
    6587584068506488869767403662460111870851709789694140241572542699619538605403,
    11065162352055215342882956665028806373710857144056793315618843991574034541745,
    27235437669367044799899874028200860893259633691548428184978833555844239099210,
    39122459949963443953695513827515422590145971775731164693081784821001500765271,
    14822541353598610072073758561600133199190898904019472753356348939736178856242,
    32119039894111509393883349238591117345166479914896997011437787663480858229324,
    43492451727584886720328582747486156090763899250669626113572962177392830153672,
    23782521420058920239581486714235942233162905749917547091367129332109148150964,
    1950261058989975858181381159018748926889722679795466088362775920975943983890,
    47763254094198808066374497304963224993617822320088130264863862435119574697678,
    44035521596650126254580286193043646937530018324533162959282567836364656349620,
    45248278075433906869650374149660178834237900630357739057386839430392516698709,
    30558481537294127342952125056358924225581206938869947160862017954746718634085,
    10702554392571105609953066033536365418563149392782994983402406449789876497692,
    34319425623279664398659085846739236990635100324667226409415519671072072962346,
)
# Stress sizes of the batched hash, not traffic: no caller in either package
# hashes a batch on the card outside its tests and bench.py.  A dense 4-ary
# tree of 4^9 leaves (the state tree's arity, hashed a level at a time, as
# the JAX module's docstring means it) and one flat batch of 2^20 arity-4
# hashes (bench.py's Poseidon shape, the batch at the card's scale: its MDS
# product alone holds three 1.68 GB tensors); below --log-d 22, 4^6 and
# 2^16.
POSEIDON_LOG4_LEAVES, POSEIDON_LOG2_BATCH = 9, 20
# Phase 8 (eddsa).  The traffic: one mainnet block, phase 6's 256 MPN
# transfers, whose signatures a validator checks (core/transaction.py:
# MpnTransaction.verify_signature).  Then a stress size, not traffic: 4,096
# signatures (16 blocks) in one call, 256 below --log-d 22.  Row i is
# signed by the key of seed b"E%d" % i over the message EDDSA_MSG0 + i.
EDDSA_SIGS = 4096
EDDSA_MSG0 = 10 ** 6
# how every 8th row of the batch is tampered, in turn
EDDSA_TAMPER = ("msg_plus_1", "s_plus_1", "other_pk", "other_r_on_curve",
                "r_off_curve")
# rows checked against the host (random) and on the plain path (the first)
HOST_ROWS = 256
PLAIN_ROWS = 256

# H100 SXM peaks: HBM3 bytes/s (NVIDIA data sheet), and 32-bit integer
# multiply-adds/s = 132 SMs x 64 IMAD per SM per clock (CUDA C++
# Programming Guide, arithmetic throughput, compute capability 9.0) x the
# 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9


def mont_mul_imads(n_limbs: int) -> int:
    """32-bit multiply-adds of one CIOS Montgomery multiply over s = n/2
    words: s^2 word products and s^2 + s reduction products, each word
    product a low and a high IMAD, the m = t0 * p' products one IMAD."""
    s = n_limbs // 2
    return 2 * s * s + 2 * s * s + s


def mont_sqr_imads(n_limbs: int) -> int:
    """The same for a Montgomery squaring: s(s + 1) / 2 distinct word
    products (the doubled cross products are shifts and adds), then the
    reduction."""
    s = n_limbs // 2
    return s * (s + 1) + 2 * s * s + s


def ntt_imads(n: int, m: int = 0) -> int:
    """32-bit multiply-adds of the radix-2 stages of NTTs over Fr of rows
    of m (0: one row of n) of n elements: one multiply per butterfly, less
    those whose twiddle is 1 (the first of each group, m - 1 a row)."""
    m = m or n
    return n // m * (m // 2 * (m.bit_length() - 1) - (m - 1)) * \
        mont_mul_imads(16)


def mont_redc_imads(n_limbs: int) -> int:
    """The same for a Montgomery reduction alone (out of Montgomery form:
    the other operand is 1)."""
    s = n_limbs // 2
    return 2 * s * s + s


def poseidon_products(t: int) -> dict:
    """Fr products of one Poseidon-t hash in `ops/poseidon.py` as written:
    the S-box x^5 (two squarings and a multiply) on every lane of a full
    round and on lane 0 of a partial one, and the dense t × t MDS product
    in every round."""
    p = params_for_width(t)
    sboxes = p.full_rounds * t + p.partial_rounds
    return {"mul": sboxes + (p.full_rounds + p.partial_rounds) * t * t,
            "sqr": 2 * sboxes, "redc": 0}


def _plus(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in ("mul", "sqr", "redc")}


# Fr products of one signature in `ops/jubjub_batch._verify_fn`: the
# Poseidon-6 hash h; h out of Montgomery form (a reduction alone); T = X·Y
# of A and of R; nine multiplies per complete add (255 of s·B, 255 of h·A,
# and R + h·A); each of h·A's 255 doublings at what a doubling needs, four
# multiplies and four squarings (dbl-2008-hwcd; the code doubles by the
# complete add); four in the projective compare.
EDDSA_PRODUCTS = _plus(poseidon_products(6),
                       {"mul": 2 + 9 * (255 + 255 + 1) + 4 * 255 + 4,
                        "sqr": 4 * 255, "redc": 1})


def product_imads(counts: dict) -> int:
    """32-bit multiply-adds of Fr products counted as above, each priced
    at its own kind: multiply, squaring, reduction."""
    return (counts["mul"] * mont_mul_imads(FR_LIMBS)
            + counts["sqr"] * mont_sqr_imads(FR_LIMBS)
            + counts["redc"] * mont_redc_imads(FR_LIMBS))


def rate_bound(counts: dict) -> float:
    """Items per second that the card's IMAD rate allows at the given Fr
    products per item (their bytes bind far less).  It bounds the schedule
    as written (the dense MDS of every round, the 255-step ladders), with
    each product at its cheapest kind."""
    return IMAD_PER_S / product_imads(counts)


def bound(nbytes: int, imads: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def emit(obj):
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------ synthetic data


class SyntheticCircuit:
    """A satisfied R1CS shaped like the MPN witness, built with numpy.

    Var 0 is ONE, var 1 the public input x = c_0.  Half the constraints are
    boolean wires (1 − b)·b = 0 (a dense ONE column, coefficient −1, and one
    huge group of equal scalars for the duplicate-scalar presum); the rest
    are a multiply chain c_k = c_{k−1}·c_{j(k)} with random earlier factors.
    Exposes what `create_proof` reads: `n_constraints`, `compiled()` and
    `full_assignment()`."""

    def __init__(self, n_constraints: int, seed: int):
        rng = np.random.default_rng(seed)
        nb = n_constraints // 2
        k = n_constraints - nb
        self.n_constraints = n_constraints
        bits = rng.integers(0, 2, nb)
        # factor of chain step t (1..k): an earlier chain value j in [0, t)
        j = (rng.random(k) * np.arange(1, k + 1)).astype(np.int64)
        x = int.from_bytes(rng.bytes(32), "little") % P
        chain = [x]
        for t in range(k):
            chain.append(chain[t] * chain[j[t]] % P)
        self.z = [1, x] + bits.tolist() + chain[1:]

        def cvar(t):  # var index of chain value c_t
            return np.where(t == 0, 1, 2 + nb + t - 1)

        rb = np.arange(nb, dtype=np.int64)
        bvar = 2 + rb
        t = np.arange(1, k + 1, dtype=np.int64)
        rc = nb + t - 1
        one = np.zeros(nb, np.int64)
        rows = (np.concatenate([np.repeat(rb, 2), rc]),
                np.concatenate([rb, rc]), rc)
        vars_ = (np.concatenate([np.stack([one, bvar], 1).ravel(),
                                 cvar(t - 1)]),
                 np.concatenate([bvar, cvar(j)]), cvar(t))
        cids = (np.concatenate([np.tile([0, 1], nb), np.zeros(k, np.int64)]),
                np.zeros(nb + k, np.int64), np.zeros(k, np.int64))
        self._compiled = CompiledR1CS(
            num_vars=len(self.z), num_inputs=2, n_constraints=n_constraints,
            rows=tuple(a.astype(np.int32) for a in rows),
            vars=tuple(a.astype(np.int32) for a in vars_),
            cids=tuple(a.astype(np.int32) for a in cids),
            palette=[1, P - 1],
        )

    def compiled(self) -> CompiledR1CS:
        return self._compiled

    def full_assignment(self):
        return self.z


def _gen(kind):
    return bls.G1_GEN if kind == "g1" else bls.G2_GEN


def _coords(kind, pt, proj: bool):
    """Host point -> Montgomery coordinate ints in the limb-major plane
    order (x y [z] for G1, x0 x1 y0 y1 [z0 z1] for G2)."""
    if kind == "g1":
        c = [0, 1, 0] if pt is None else [pt[0], pt[1], 1]
        return c if proj else c[:2]
    c = ([0, 0, 1, 0, 0, 0] if pt is None
         else [pt[0][0], pt[0][1], pt[1][0], pt[1][1], 1, 0])
    return c if proj else c[:4]


def broadcast_lanes(kind, pt, n: int, proj: bool, device):
    """One host point in every one of n limb-major lanes."""
    col = fp_field().encode(np.array(_coords(kind, pt, proj), dtype=object),
                            device=device)  # (planes, 24)
    return col[:, :, None].expand(-1, -1, n).contiguous()


def prefix_points(kind: str, a: int, b: int, n: int, device):
    """Limb-major projective points (a + i·b)·G for i < n, built on the
    device with log2(n) masked mixed adds (K2 or K4): lane i adds 2^k·b·G
    where bit k of i is set."""
    add = bls.g1_add if kind == "g1" else bls.g2_add
    mul = bls.g1_mul if kind == "g1" else bls.g2_mul
    madd = ck.madd_select_lm if kind == "g1" else ck.madd_select_g2_lm
    acc = broadcast_lanes(kind, mul(_gen(kind), a % R_ORDER), n, True, device)
    step = mul(_gen(kind), b % R_ORDER)
    lane = torch.arange(n, device=device)
    k = 0
    while (1 << k) < n:
        q = broadcast_lanes(kind, step, n, False, device)
        acc = madd(acc, q, ((lane >> k) & 1).bool())
        step = add(step, step)
        k += 1
    return acc


def lm_to_am(kind: str, acc):
    """Limb-major projective (n_proj, 24, L) -> ((L, n_aff, 24), (L,) inf)."""
    if kind == "g1":
        return wst.g1_proj_to_am((acc[0].T, acc[1].T, acc[2].T))
    return wst.g2_proj_to_am(((acc[0].T, acc[1].T), (acc[2].T, acc[3].T),
                              (acc[4].T, acc[5].T)))


def synthetic_params(num_vars: int, n_inputs: int, d: int, seed: int,
                     device):
    """A proving key whose query point i is (a_q + i·b_q)·G for random a_q,
    b_q, and whose α, β, δ are known: returns (Parameters, scalars).  Rows
    past each query's length are infinity, as keygen pads them.  b_g1 and
    b_g2 share their logs, as v_i(τ) is shared in a real key."""
    rng = np.random.default_rng(seed)

    def rand():
        return int.from_bytes(rng.bytes(40), "little") % (R_ORDER - 1) + 1

    sc = {name: rand() for name in ("alpha", "beta", "delta")}
    for q in ("a", "b", "l", "h"):
        sc[q] = (rand(), rand())
    Np = msm_lm.msm_pad_len(max(num_vars, d - 1))
    rows = torch.arange(Np, device=device)

    def query(kind, ab, n_valid):
        am, inf = lm_to_am(kind, prefix_points(kind, *ab, Np, device))
        return am, inf | (rows >= n_valid)

    g1, g2 = bls.G1_GEN, bls.G2_GEN
    pk = keygen.ProvingKey(
        alpha_g1=bls.g1_mul(g1, sc["alpha"]),
        beta_g1=bls.g1_mul(g1, sc["beta"]),
        beta_g2=bls.g2_mul(g2, sc["beta"]),
        delta_g1=bls.g1_mul(g1, sc["delta"]),
        delta_g2=bls.g2_mul(g2, sc["delta"]),
        a_query=query("g1", sc["a"], num_vars),
        b_g1_query=query("g1", sc["b"], num_vars),
        b_g2_query=query("g2", sc["b"], num_vars),
        h_query=query("g1", sc["h"], d - 1),
        l_query=query("g1", sc["l"], num_vars - n_inputs),
        num_inputs=n_inputs,
    )
    w1, w2 = keygen.g1_wire, keygen.g2_wire
    # not a verifying key for this circuit: the queries are not the QAP's
    vk = Groth16VerifyingKey(w1(pk.alpha_g1), w1(pk.beta_g1), w2(pk.beta_g2),
                             w2(g2), w1(pk.delta_g1), w2(pk.delta_g2), [])
    return keygen.Parameters(pk=pk, vk=vk), sc


def expected_proof(z, h, n_inputs: int, sc: dict, r: int, s: int):
    """(A, B, C) of the synthetic key from scalars alone:
    Σ_i v_i·(a + i·b) = a·Σv_i + b·Σ i·v_i."""
    def dot(ab, v):
        a, b = ab
        return (a * sum(v) + b * sum(i * x for i, x in enumerate(v))) % R_ORDER

    a_s = (sc["alpha"] + dot(sc["a"], z) + r * sc["delta"]) % R_ORDER
    b_s = (sc["beta"] + dot(sc["b"], z) + s * sc["delta"]) % R_ORDER
    c_s = (dot(sc["l"], z[n_inputs:]) + dot(sc["h"], h) + s * a_s + r * b_s
           - r * s * sc["delta"]) % R_ORDER
    return (bls.g1_mul(bls.G1_GEN, a_s), bls.g2_mul(bls.G2_GEN, b_s),
            bls.g1_mul(bls.G1_GEN, c_s))


def _powers(x: int, n: int, device):
    """(n, 16) Montgomery x^0..x^(n−1), by doubling the prefix."""
    F = fr_field()
    out = F.const_mont(1, device)[None]
    while out.shape[0] < n:
        step = F.const_mont(pow(x, out.shape[0], P), device)
        out = torch.cat([out, F.mont_mul(out, step)])
    return out[:n]


def _limb_sum(x) -> int:
    """Σ over rows of (N, 16) limbs, as the integer Σ_k (Σ limb_k)·2^16k."""
    sums = x.to(torch.int64).sum(dim=0).cpu().tolist()
    return sum(int(v) << (16 * k) for k, v in enumerate(sums))


def circuit_at(comp: CompiledR1CS, z, d: int, rho: int, device):
    """(a(ρ), b(ρ), c(ρ)) of the QAP straight from the circuit: the sum
    over every term (row j, var i, coefficient k) of k·z_i·L_j(ρ), where
    L_j(ρ) = (ρ^d − 1)/d · ω^j/(ρ − ω^j) is the Lagrange basis on H = <ω>
    (barycentric form).  A also holds bellman's input rows a_{n+i} = z_i.
    Reads comp.rows/vars/cids, not the prover's row plans."""
    F = fr_field()
    omega = pow(FR_GENERATOR, (P - 1) // d, P)
    wpow = _powers(omega, d, device)
    den = F.sub(F.const_mont(rho, device).expand(d, FR_LIMBS), wpow)
    wt = F.mont_mul(wpow, F.inv_mont(den))
    z_mont = F.to_mont(F.encode(np.array(z, dtype=object), mont=False,
                                device=device))
    pal = F.encode(np.array(comp.palette, dtype=object), device=device)
    scale = ((pow(rho, d, P) - 1) * pow(d, -1, P)
             * pow(F.R_mod_p, -1, P) % P)
    n, ni = comp.n_constraints, comp.num_inputs
    out = []
    for m in range(3):
        rows, vars_, cids = (torch.from_numpy(x.astype(np.int64)).to(device)
                             for x in (comp.rows[m], comp.vars[m],
                                       comp.cids[m]))
        acc = _limb_sum(F.mont_mul(F.mont_mul(z_mont[vars_], wt[rows]),
                                   pal[cids]))
        if m == 0:
            acc += _limb_sum(F.mont_mul(z_mont[:ni], wt[n:n + ni]))
        out.append(acc * scale % P)
    return out


def h_identity_holds(comp: CompiledR1CS, z, h_std, d: int, rho: int) -> bool:
    """a(ρ)·b(ρ) − c(ρ) == h(ρ)·Z(ρ), Z(ρ) = ρ^d − 1, h(ρ) = Σ_j h_j·ρ^j."""
    F = fr_field()
    dev = h_std.device
    a, b, c = circuit_at(comp, z, d, rho, dev)
    z_rho = (pow(rho, d, P) - 1) % P
    h = _limb_sum(F.mont_mul(h_std, _powers(rho, h_std.shape[0], dev))) % P
    return (a * b - c - h * z_rho) % P == 0


# ------------------------------------------------------------ keygen checks

QUERY_NAMES = ("a_query", "b_g1_query", "l_query", "h_query", "b_g2_query")
HEAD_FIELDS = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
               "num_inputs")


def key_equals_file(params, path: str) -> dict:
    """A generated key against a key file: each query's limbs and flags,
    the head points and the VK's wire bytes."""
    ref = keygen.load_parameters(path, device=params.pk.a_query[0].device)
    out = {}
    for name in QUERY_NAMES:
        (am, inf), (ram, rinf) = getattr(params.pk, name), getattr(ref.pk, name)
        out[name] = bool(torch.equal(am, ram) and torch.equal(inf, rinf))
    out["head"] = all(getattr(params.pk, f) == getattr(ref.pk, f)
                      for f in HEAD_FIELDS)
    out["vk_bytes"] = ser.dumps(params.vk) == ser.dumps(ref.vk)
    return out


def lagrange_host(rows, tau: int, d: int) -> dict:
    """{j: L_j(τ)} for the given rows from the barycentric form
    ω^j (τ^d − 1) / (d (τ − ω^j)).  ω^j is a running product over the
    sorted rows and the denominators are inverted together (prefix
    products, one inversion): the ONE column touches ~1.6M rows at
    d = 2^22."""
    omega = pow(FR_GENERATOR, (P - 1) // d, P)
    scale = (pow(tau, d, P) - 1) * pow(d, -1, P) % P
    js = np.unique(rows).tolist()
    steps = {}
    ws, wj, prev = [], 1, 0
    for j in js:
        gap = j - prev
        if gap not in steps:
            steps[gap] = pow(omega, gap, P)
        wj = wj * steps[gap] % P
        ws.append(wj)
        prev = j
    prefix = [1]
    for w in ws:
        prefix.append(prefix[-1] * (tau - w) % P)
    inv = pow(prefix[-1], -1, P)
    out = {}
    for i in range(len(js) - 1, -1, -1):
        out[js[i]] = ws[i] * scale % P * (prefix[i] * inv % P) % P
        inv = inv * (tau - ws[i]) % P
    return out


def column_scalars(comp: CompiledR1CS, var_ids, tau: int, d: int) -> dict:
    """{var: [u, v, w]} at τ, each summed over its own column's terms
    (A with bellman's input rows a_{n+i} = z_i)."""
    need = np.array(sorted(set(var_ids)), dtype=np.int64)
    n, ni = comp.n_constraints, comp.num_inputs
    terms = []
    for m in range(3):
        sel = np.isin(comp.vars[m], need)
        terms.append((comp.rows[m][sel], comp.vars[m][sel], comp.cids[m][sel]))
    ext = n + need[need < ni]
    L = lagrange_host(np.concatenate([t[0] for t in terms] + [ext]), tau, d)
    out = {int(v): [0, 0, 0] for v in need}
    for m, (rows, vars_, cids) in enumerate(terms):
        for j, v, c in zip(rows.tolist(), vars_.tolist(), cids.tolist()):
            out[v][m] = (out[v][m] + comp.palette[c] * L[j]) % P
    for v in need[need < ni].tolist():
        out[v][0] = (out[v][0] + L[n + v]) % P
    return out


def sample_rows(n_valid: int, n_rows: int, k: int, rng) -> list:
    """Up to k row indices: the first and last valid row, one pad row if
    there is one, the rest random valid rows."""
    fixed = {0, n_valid - 1}
    if n_rows > n_valid:
        fixed.add(int(rng.integers(n_valid, n_rows)))
    rest = rng.choice(n_valid, size=min(k, n_valid), replace=False).tolist()
    for i in rest:
        if len(fixed) >= k:
            break
        fixed.add(int(i))
    return sorted(fixed)


def gen_mul(kind: str, scalar: int):
    return (bls.g1_mul if kind == "g1" else bls.g2_mul)(_gen(kind), scalar)


def key_points(kind: str, query, idx) -> list:
    """Host affine points of rows idx of a (limbs, inf) query; a row at
    infinity must hold zero limbs (it reads as "bad" otherwise)."""
    am, inf = query
    sel = torch.tensor(idx, device=am.device)
    rows = am[sel]
    decode = keygen._decode_g1_am if kind == "g1" else keygen._decode_g2_am
    zero = (rows == 0).flatten(1).all(dim=1).tolist()
    return [p if p is not None or z else "bad"
            for p, z in zip(decode(rows, inf[sel]), zero)]


def key_spot_check(comp: CompiledR1CS, params, seed: bytes, d: int,
                   k: int = 16, rng_seed: int = ROOT_SEED):
    """Rows of each query and every VK point of a generated key against
    the generator times a scalar recomputed on the host: τ, α, β, γ, δ
    from the seed, u_i(τ), v_i(τ), w_i(τ) from column i's own terms, and
    τ^i·Z(τ)/δ for the h query.  Returns ({check: bool}, rows sampled)."""
    tau, alpha, beta, gamma, delta = keygen._rng_scalars(seed, 5, b"toxic")
    pk, vk = params.pk, params.vk
    ni, nv = comp.num_inputs, comp.num_vars
    n_rows = pk.a_query[0].shape[0]
    valid = {"a_query": nv, "b_g1_query": nv, "b_g2_query": nv,
             "l_query": nv - ni, "h_query": d - 1}
    rng = np.random.default_rng(rng_seed)
    idx = {name: sample_rows(valid[name], n_rows, k, rng)
           for name in QUERY_NAMES}
    need = set(range(ni))
    for name in ("a_query", "b_g1_query", "b_g2_query"):
        need |= {i for i in idx[name] if i < nv}
    need |= {ni + i for i in idx["l_query"] if i < nv - ni}
    cols = column_scalars(comp, need, tau, d)
    g_inv, d_inv = pow(gamma, -1, P), pow(delta, -1, P)
    z_tau = (pow(tau, d, P) - 1) % P

    def combo(v):
        u, vv, w = cols[v]
        return (beta * u + alpha * vv + w) % P

    scalar = {
        "a_query": lambda i: cols[i][0],
        "b_g1_query": lambda i: cols[i][1],
        "b_g2_query": lambda i: cols[i][1],
        "l_query": lambda i: combo(ni + i) * d_inv % P,
        "h_query": lambda i: pow(tau, i, P) * z_tau % P * d_inv % P,
    }
    out = {}
    for name in QUERY_NAMES:
        kind = "g2" if name == "b_g2_query" else "g1"
        want = [gen_mul(kind, scalar[name](i)) if i < valid[name] else None
                for i in idx[name]]
        out[name] = key_points(kind, getattr(pk, name), idx[name]) == want
    w1, w2 = keygen.g1_wire, keygen.g2_wire
    out["vk_ic"] = vk.ic == [w1(gen_mul("g1", combo(v) * g_inv % P))
                             for v in range(ni)]
    out["vk_head"] = (
        (vk.alpha_g1, vk.beta_g1, vk.delta_g1)
        == tuple(w1(gen_mul("g1", x)) for x in (alpha, beta, delta))
        and (vk.beta_g2, vk.gamma_g2, vk.delta_g2)
        == tuple(w2(gen_mul("g2", x)) for x in (beta, gamma, delta))
        and (w1(pk.alpha_g1), w1(pk.beta_g1), w1(pk.delta_g1),
             w2(pk.beta_g2), w2(pk.delta_g2))
        == (vk.alpha_g1, vk.beta_g1, vk.delta_g1, vk.beta_g2, vk.delta_g2))
    return out, sum(len(v) for v in idx.values())


# ------------------------------------------------------------- the phases


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def peak_requested():
    """Peak of the bytes the tensors asked for since the last reset of the
    peak stats: `max_memory_allocated` less the caching allocator's
    rounding and the unsplit remainders of reused blocks (up to 1 MiB
    each), which depend on what was allocated and freed before."""
    return torch.cuda.memory_stats().get("requested_bytes.all.peak")


def random_field_limbs(F, n: int, gen, device):
    """(n, F.n) canonical limbs: random 16-bit limbs, top limb below p's."""
    x = torch.randint(0, 1 << 16, (n, F.n), generator=gen, device=device,
                      dtype=torch.int32)
    top = (F.p >> (16 * (F.n - 1))) & 0xFFFF
    x[:, -1] = torch.randint(0, top, (n,), generator=gen, device=device,
                             dtype=torch.int32)
    return x


def timed_once(fn):
    """(fn(), its milliseconds by CUDA events)."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def check_kernel(name, size, launches, run_kernel, run_plain, nbytes, imads,
                 reps=20, timed=None, extra=None, plain_ms=None):
    """One kernel at one launch size: bit-exact against the plain version,
    then timed (`timed`, where the checked call does more than the
    kernel's launch, else `run_kernel`).  The plain version's checked
    call is its timed call (one call beside a kernel 100-10,000 times
    faster), unless `plain_ms` gives the time of the call that computed
    `run_plain()`'s result with other sizes'.  `launches` is how often
    the proof launched this size; `extra` adds keys to the row."""
    out_k = run_kernel()
    out_p, ms_p = timed_once(run_plain)
    err = int((out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max())
    ms = cuda_ms(timed or run_kernel, reps)
    plain_ms = ms_p if plain_ms is None else plain_ms
    bound_ms, bound_by = bound(nbytes, imads)
    row = {"phase": "kernel", "name": name, "size": list(size),
           "launches": launches, "max_abs_err": float(err), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           **(extra or {})}
    emit(row)
    if err != 0:
        raise SystemExit(f"{name} at {size}: kernel disagrees with its "
                         "plain version")
    return row


def summarize(rows):
    """A kernel's per-size rows -> its times per launch averaged over the
    proof, each size weighted by how often the proof launched it."""
    n = sum(r["launches"] for r in rows)
    out = {k: sum(r[k] * r["launches"] for r in rows) / n
           for k in ("ms", "plain_ms", "bound_ms")}
    by_bytes = sum(r["bound_ms"] * r["launches"] for r in rows
                   if r["bound_by"] == "bytes")
    out["bound_by"] = ("bytes" if 2 * by_bytes >= out["bound_ms"] * n
                       else "operations")
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["library_ms"] = None
    out["sizes"] = len(rows)
    out["per_size"] = rows
    return out


def launch_weighted(summary, sizes: dict) -> dict:
    """A kernel's replay rows weighted by one run's launches ({(n, extra):
    count}, as `_cuda.sizes()` gives them): the launches, ms and bound_ms
    per launch averaged over them, and launches × (ms − bound_ms)."""
    n = ms = bound_ms = 0
    for (size, extra), count in sizes.items():
        row = next(r for r in summary["per_size"] if r["size"][0] == size
                   and r["size"][1:] in ([], [extra]))
        n += count
        ms += row["ms"] * count
        bound_ms += row["bound_ms"] * count
    if not n:
        return {"launches": 0}
    return {"launches": n, "ms": ms / n, "bound_ms": bound_ms / n,
            "excess_ms": ms - bound_ms}


# per group: (kernel, wrapper, plain version, Fp multiplies per lane) for
# affine Q, then for projective Q
CURVE_KERNELS = {
    "g1": ((ck.K_G1_MADD, ck.madd_select_lm, ck.madd_select_lm_plain, 11),
           (ck.K_G1_ADD, ck.add_select_lm, ck.add_select_lm_plain, 12)),
    "g2": ((ck.K_G2_MADD, ck.madd_select_g2_lm, ck.madd_select_g2_lm_plain,
            33),
           (ck.K_G2_ADD, ck.add_select_g2_lm, ck.add_select_g2_lm_plain, 36)),
}


# K6/K7: (kernel, wrapper, plain version, group, Fp multiplies per lane)
FULL_ADD_KERNELS = (
    (ck.K_G1_FULL, ck.g1_add_lm, ck.g1_add_lm_plain, "g1", 12),
    (ck.K_G2_FULL, ck.g2_add_lm, ck.g2_add_lm_plain, "g2", 36),
)
FULL_ADD_NAMES = tuple(k[0].name for k in FULL_ADD_KERNELS)
# lane counts at which K6/K7 are always replayed: keygen's GEN_CHUNK and
# one less (K6's replay time at these two was bimodal on its first port)
FULL_ADD_ALWAYS = (keygen.GEN_CHUNK - 1, keygen.GEN_CHUNK)
K1_NAMES = (fk.K_FR.name, fk.K_FP.name, fk.K_NTT.name, fk.K_INV.name)
# (elements, row length) at which K1's stage entry is always replayed: the
# four-step's row transforms over a whole 2^23 and 2^24 array
NTT_ROWS_ALWAYS = ((1 << 23, 1 << 11), (1 << 24, 1 << 12))
# the kernels each driven path must have launched (keygen runs no NTT)
PROOF_KERNELS = K1_NAMES + tuple(k[0].name for group in CURVE_KERNELS.values()
                                 for k in group)
KEYGEN_KERNELS = (fk.K_FR.name, fk.K_FP.name, fk.K_INV.name) + FULL_ADD_NAMES
# 32-bit multiply-adds that z^(p - 2) over Fp needs per element, at the
# least: as many squarings as p - 2 has bits less one, and one multiply
# per sliding 4-bit window (the windows' table of odd powers, part of the
# kernel's own chain, is not counted).
INV_FP_IMADS = ((fp_field().p - 2).bit_length() - 1) * mont_sqr_imads(
    FP_LIMBS) + len(fk.fermat_windows(fp_field().p - 2)[1]) * mont_mul_imads(
    FP_LIMBS)


def k1_operands(F, n: int, b_rows: int, gen, device):
    """Random canonical operands of a K1 launch over n elements whose b has
    b_rows rows, shaped as the proof hands them to the wrapper: a viewed
    (n / b_rows, b_rows, limbs) against b (b_rows, limbs), so b repeats
    over a's leading axis (constants, coset scales) or not.  Among them
    0, (p − 1)², and R − 1 (every limb 0xFFFF) against a canonical row
    in each operand: K1 takes one operand below R, as the row
    evaluation's redundant sums are."""
    a = random_field_limbs(F, n, gen, device)
    b = random_field_limbs(F, b_rows, gen, device)
    p_minus_1 = to_torch(int_to_limbs(F.p - 1, F.n), device)
    a[-1] = p_minus_1  # (p − 1)², the largest canonical product
    b[-1] = p_minus_1
    if n > 1:
        a[0] = 0
    if n > 2:
        a[1] = 0xFFFF  # against b[1 % b_rows], canonical
    if b_rows > 3:
        b[2] = 0xFFFF  # against a[2 + k b_rows], canonical
    return a.view(n // b_rows, b_rows, F.n), b


# The plain K1 multiply's int64 arithmetic needs about 100 times its
# operands' bytes, so the replay holds a larger launch to it in slices.
PLAIN_SLICE = 1 << 22


def mont_mul_plain_sliced(F, a, b):
    """K1's plain version on `k1_operands`' (m, b_rows, limbs) a against
    (b_rows, limbs) b, at most PLAIN_SLICE elements at a time (the same
    elementwise products)."""
    m, rows = a.shape[0], a.shape[1]
    if m * rows <= PLAIN_SLICE:
        return fk.mont_mul_plain(F, a, b)
    if rows <= PLAIN_SLICE:
        step = PLAIN_SLICE // rows
        return torch.cat([fk.mont_mul_plain(F, a[i:i + step], b)
                          for i in range(0, m, step)])
    return torch.cat([torch.cat([
        fk.mont_mul_plain(F, a[i:i + 1, j:j + PLAIN_SLICE],
                          b[j:j + PLAIN_SLICE])
        for j in range(0, rows, PLAIN_SLICE)], dim=1) for i in range(m)])


def ntt_operands(n: int, gen, device, m: int = 0):
    """Random canonical Fr limbs for the NTT's stages at size n in rows of
    m (0: one row of n), with 0 and p − 1 among them, and the forward
    transform's packed twiddles of the row length."""
    m = m or n
    F = fr_field()
    x = random_field_limbs(F, n, gen, device)
    x[0] = 0
    x[-1] = to_torch(int_to_limbs(F.p - 1, F.n), device)
    log_m = m.bit_length() - 1
    return x, ntt_mod._stage_twiddles(log_m, False, str(device))


def inv_operands(n: int, gen, device):
    """Random canonical Fp limbs for the inversion, the first of them
    p − 1, 1, one in Montgomery form (R mod p) and 0, as many as fit."""
    F = fp_field()
    x = random_field_limbs(F, n, gen, device)
    edges = [F.p - 1, 1, F.R_mod_p, 0]
    for i, v in enumerate(edges[:n]):
        x[i] = to_torch(int_to_limbs(v, F.n), device)
    return x


def curve_operands(kind: str, n_lanes: int, gen, device):
    """Limb-major P (projective), affine Q, projective Q and a mask over
    n_lanes lanes: random valid points plus the cases RCB15 must handle,
    P = identity, P = Q, P = −Q, Q = identity and masked-off lanes."""
    lane = torch.arange(n_lanes, device=device)
    q_proj = prefix_points(kind, 3, 5, n_lanes, device)
    p_proj = prefix_points(kind, 7, 11, n_lanes, device)
    q_aff = lm_to_am(kind, q_proj)[0].permute(1, 2, 0).contiguous()
    y = slice(1, 2) if kind == "g1" else slice(2, 4)
    ident = broadcast_lanes(kind, None, n_lanes, True, device)
    acc = p_proj.clone()
    acc[:, :, 0::8] = ident[:, :, 0::8]             # P = identity
    acc[:, :, 1::8] = q_proj[:, :, 1::8]            # P = Q: doubling
    neg = q_proj[:, :, 2::8].clone()                # P = −Q
    neg[y] = fp_field().neg(neg[y].transpose(1, 2)).transpose(1, 2)
    acc[:, :, 2::8] = neg
    q_with_id = q_proj.clone()
    q_with_id[:, :, 4::8] = ident[:, :, 4::8]       # Q = identity
    mask = (lane % 8 != 3) & (torch.rand(
        n_lanes, generator=gen, device=device) < 0.9)  # masked-off lanes
    return acc, q_aff, q_with_id, mask


def stress_lanes(acc, q, mask):
    """Copies of a curve add's operands (Q affine or projective) with the
    top of the range: in lanes 5 mod 8 every coordinate of acc and Q is
    p − 1, in lanes 6 mod 8 the planes alternate p − 1 and 0, and both are
    active.  These points are off the curve, but RCB15 is one polynomial
    map, so the kernel must still equal its plain version; they are where
    a lazy reduction would overflow."""
    F = fp_field()
    pm1 = to_torch(int_to_limbs(F.p - 1, F.n), acc.device)[:, None]
    acc, q, mask = acc.clone(), q.clone(), mask.clone()
    for x in (acc, q):
        x[:, :, 5::8] = pm1
        for plane in range(x.shape[0]):
            x[plane, :, 6::8] = pm1 if plane % 2 == 0 else 0
    mask[5::8] = True
    mask[6::8] = True
    return acc, q, mask


def inversion_rows(sizes: dict, gen, device) -> list:
    """K1's Fp inversion at each of `sizes` ({(n, 0): launches}) against
    its plain version.  The plain inversion, a chain of about 460
    launch-bound multiplies, takes 5-6 s at any of these sizes: one call
    over every size's operands checks them all, and its time is each
    row's plain_ms."""
    F = fp_field()
    inv = sorted(sizes.items())
    xs = [inv_operands(n, gen, device) for (n, _), _ in inv]
    want, plain_ms = timed_once(lambda: fk.mont_inv_plain(F, torch.cat(xs)))
    return [check_kernel(
        fk.K_INV.name, (n,), count, lambda: fk.mont_inv(F, x), lambda: w,
        2 * n * F.n * 4, n * INV_FP_IMADS, reps=5, plain_ms=plain_ms,
        extra={"plain_rows": want.shape[0]})
        for ((n, _), count), x, w in zip(inv, xs, want.split(
            [n for (n, _), _ in inv]))]


def kernel_phase(sizes: dict, device):
    """Replay every kernel at each size `sizes` (from the driven paths)
    holds."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    rows = {}
    for F, kern in ((fr_field(), fk.K_FR), (fp_field(), fk.K_FP)):
        per = []
        for (n, b_rows), count in sorted(sizes[kern.name].items()):
            a, b = k1_operands(F, n, b_rows, gen, device)
            per.append(check_kernel(
                kern.name, (n, b_rows), count,
                lambda: fk.mont_mul(F, a, b),
                lambda: mont_mul_plain_sliced(F, a, b),
                (2 * n + b_rows) * F.n * 4, n * mont_mul_imads(F.n)))
            del a, b
        rows[kern.name] = summarize(per)

    F = fr_field()
    per = []
    # the four-step's row stages at 2^23 and 2^24 elements, whatever the
    # run's sizes; a size no phase launched weighs nothing in the averages
    replay = {size: 0 for size in NTT_ROWS_ALWAYS}
    replay.update(sizes[fk.K_NTT.name])
    for (n, row), count in sorted(replay.items()):
        m = row or n
        x, tw = ntt_operands(n, gen, device, m)
        work = x.clone()
        passes = 1 + max(m.bit_length() - 1 - fk.NTT_LOW_LOG, 0)
        row_bytes = F.n * 4
        per.append(check_kernel(
            fk.K_NTT.name, (n, row), count,
            lambda: fk.ntt_stages_(x.clone(), tw, row=row),
            lambda: fk.ntt_stages_plain(x, tw, row=row),
            (2 * n + m - 1) * row_bytes, ntt_imads(n, m), reps=5,
            timed=lambda: fk.ntt_stages_(work, tw, row=row),
            # a diagnostic, not a bound of the function: the bytes of the
            # kernel's own passes, each reading and writing every row
            extra={"passes": passes, "diag_passes_bytes_ms": bound(
                (2 * passes * n + m - 1) * row_bytes, 0)[0]}))
        del x, tw, work
    rows[fk.K_NTT.name] = summarize(per)

    rows[fk.K_INV.name] = summarize(inversion_rows(
        sizes[fk.K_INV.name], gen, device))

    for kind in ("g1", "g2"):
        kerns = CURVE_KERNELS[kind]
        n_max = max(L for k in kerns for L, _ in sizes[k[0].name])
        acc, q_aff, q_with_id, mask = curve_operands(kind, n_max, gen, device)
        for (kern, api, plain, n_mul), q_k in zip(kerns, (q_aff, q_with_id)):
            acc_k, q, mask_k = stress_lanes(acc, q_k, mask)
            per = []
            for (L, _), count in sorted(sizes[kern.name].items()):
                acc_l = acc_k[:, :, :L].contiguous()
                q_l = q[:, :, :L].contiguous()
                mask_l = mask_k[:L].contiguous()
                active = int(mask_l.sum())
                # acc read and out written in every lane, Q read where active
                nbytes = (L * (2 * acc.shape[0] * FP_LIMBS * 4 + 1)
                          + active * q.shape[0] * FP_LIMBS * 4)
                per.append(check_kernel(
                    kern.name, (L,), count,
                    lambda: api(acc_l, q_l, mask_l),
                    lambda: plain(acc_l, q_l, mask_l),
                    nbytes, active * n_mul * mont_mul_imads(FP_LIMBS),
                    reps=10))
            rows[kern.name] = summarize(per)

    for kern, api, plain, kind, n_mul in FULL_ADD_KERNELS:
        # keygen's chunk and one lane short of it, whatever the run's
        # sizes; a size no phase launched weighs nothing in the averages
        replay = {(n, 0): 0 for n in FULL_ADD_ALWAYS}
        replay.update(sizes[kern.name])
        n_max = max(L for L, _ in replay)
        # P: identity, P = Q, P = −Q in some lanes; Q: identity in others;
        # Z ≠ 1 on both sides elsewhere; then every coordinate p − 1 or
        # alternating p − 1 and 0 in lanes 5 and 6 mod 8
        p_pts, _, q_pts, _ = curve_operands(kind, n_max, gen, device)
        p_pts, q_pts, _ = stress_lanes(
            p_pts, q_pts, torch.ones(n_max, dtype=torch.bool, device=device))
        per = []
        for (L, _), count in sorted(replay.items()):
            p_l = p_pts[:, :, :L].contiguous()
            q_l = q_pts[:, :, :L].contiguous()
            per.append(check_kernel(
                kern.name, (L,), count,
                lambda: api(p_l, q_l), lambda: plain(p_l, q_l),
                3 * L * p_pts.shape[0] * FP_LIMBS * 4,
                L * n_mul * mont_mul_imads(FP_LIMBS), reps=10))
        rows[kern.name] = summarize(per)
    return rows


def merge_phases(*phases):
    """Launch counts and sizes of several phases, summed per kernel."""
    launches = {name: sum(p[0][name] for p in phases)
                for name in _cuda.REGISTRY}
    sizes = {}
    for name in _cuda.REGISTRY:
        merged = {}
        for _, sz in phases:
            for key, count in sz[name].items():
                merged[key] = merged.get(key, 0) + count
        sizes[name] = merged
    return launches, sizes


def toy_circuit(x: int = 3, y: int = 5):
    """The committed toy key's circuit: public z = x·y, witness x, y and
    s = x + y (2 constraints).  Returns (cs, z)."""
    cs = ConstraintSystem(proving=True)
    z = x * y % P
    z_var = cs.alloc_input(z)
    x_var = cs.alloc(x)
    y_var = cs.alloc(y)
    cs.enforce(lc((x_var, 1)), lc((y_var, 1)), lc((z_var, 1)))
    s_var = cs.alloc(x + y)
    cs.enforce(lc((x_var, 1), (y_var, 1)), lc((ONE, 1)), lc((s_var, 1)))
    return cs, z


def toy_phase(device):
    params = keygen.load_parameters(TOY_KEY, device=device)
    cs, z = toy_circuit()
    t0 = time.perf_counter()
    proof = prove.create_proof(params, cs, r=7, s=11, device=device)
    seconds = time.perf_counter() - t0
    same = ser.dumps(proof).hex() == TOY_PROOF_HEX
    verdicts = [groth16_verify(params.vk, inp, proof)
                for inp in ([z], [z + 1], [z, 0])]
    emit({"phase": "toy", "seconds": seconds, "bytes_equal_jax": same,
          "verify_accepts_z": verdicts[0],
          "verify_rejects_z_plus_1": not verdicts[1],
          "verify_rejects_two_inputs": not verdicts[2]})
    if not (same and verdicts == [True, False, False]):
        raise SystemExit("toy proof disagrees with the JAX package")


def constraints_for(log_d: int) -> int:
    """The MPN batch-64 constraint count scaled to a d = 2^log_d domain."""
    if log_d <= 22:
        return MPN_B64_CONSTRAINTS >> (22 - log_d)
    return MPN_B64_CONSTRAINTS << (log_d - 22)


def real_size_setup(log_d: int, device, seed: int = ROOT_SEED):
    """The synthetic circuit and key for a d = 2^log_d proof."""
    n_cons = constraints_for(log_d)
    cs = SyntheticCircuit(n_cons, seed)
    comp = cs.compiled()
    d = qap.domain_size(n_cons, comp.num_inputs)
    params, sc = synthetic_params(comp.num_vars, comp.num_inputs, d, seed,
                                  device)
    return cs, params, sc, d


def check_real_proof(cs, params, sc, d, proof, record, r, s, rho):
    """Every check of phase 4; returns a dict of verdicts."""
    F = fr_field()
    h_std = record["h_std"]
    h_ints = [int(v) for v in np.atleast_1d(F.decode(h_std, mont=False))]
    A, B, C = expected_proof(cs.z, h_ints, params.pk.num_inputs, sc, r, s)
    return {
        "a_equal_host": proof.a == keygen.g1_wire(A),
        "b_equal_host": proof.b == keygen.g2_wire(B),
        "c_equal_host": proof.c == keygen.g1_wire(C),
        "h_identity": h_identity_holds(cs.compiled(), cs.z, h_std, d, rho),
    }


def proof_phase(log_d: int, device):
    t0 = time.perf_counter()
    cs, params, sc, d = real_size_setup(log_d, device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    comp = cs.compiled()
    Np = params.pk.a_query[0].shape[0]
    r, s = 1234567, 7654321
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    record = {}
    t1 = time.perf_counter()
    proof = prove.create_proof(params, cs, r=r, s=s, device=device,
                               record=record)
    torch.cuda.synchronize()
    total = time.perf_counter() - t1
    launches = _cuda.counts()
    sizes = _cuda.sizes()
    peak = torch.cuda.max_memory_allocated()
    requested = peak_requested()
    rho = int.from_bytes(np.random.default_rng(ROOT_SEED).bytes(32),
                         "little") % P
    checks = check_real_proof(cs, params, sc, d, proof, record, r, s, rho)
    emit({"phase": "proof", "log_d": log_d, "d": d, "Np": Np,
          "n_constraints": comp.n_constraints, "num_vars": comp.num_vars,
          "n_terms": [int(a.shape[0]) for a in comp.rows],
          "n_heavy_vals": record["n_heavy_vals"], "setup_s": setup_s,
          "stage_s": record["seconds"], "total_s": total,
          "max_memory_allocated": peak,
          "max_memory_requested": requested, "launches": launches, **checks})
    if not all(checks.values()):
        raise SystemExit(f"real-size proof failed its checks: {checks}")
    require_launched("proof", PROOF_KERNELS, launches)
    drain_profile(params, cs, device)
    h_profile(params, cs, d, device)
    return launches, sizes


# device kernel name -> kernel row, for the profile of the drain: a key
# matches where "::" + key is in the name, so it starts at the function's
# own name ("add_select_kernel<..." would not match "madd_select_kernel<...")
PROFILED_KERNELS = (
    ("madd_select_kernel<bz::lazy::G1Lazy", ck.K_G1_MADD.name),
    ("madd_select_kernel<bz::lazy::G2Lazy", ck.K_G2_MADD.name),
    ("proj_add_select_kernel<bz::lazy::G1Lazy", ck.K_G1_ADD.name),
    ("proj_add_select_kernel<bz::lazy::G2Lazy", ck.K_G2_ADD.name),
    ("proj_add_kernel<bz::lazy::G1Lazy", ck.K_G1_FULL.name),
    ("proj_add_kernel<bz::lazy::G2Lazy", ck.K_G2_FULL.name),
    ("mont_mul_kernel", "mont_mul"),
    ("mont_inv_fp_kernel", fk.K_INV.name),
    ("ntt_low_kernel", fk.K_NTT.name),
    ("ntt_stage_kernel", fk.K_NTT.name),
)


def profiled_row(device_name: str) -> str:
    """The kernel row of a device kernel's name, or "other"."""
    return next((row for key, row in PROFILED_KERNELS
                 if "::" + key in device_name), "other")


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


# "other" device time is also broken down by name, the longest first
OTHER_NAMES = 12
OTHER_NAME_CHARS = 160


def _raw_device_events(prof):
    """(name, start µs, length µs) of every device event of a trace, read
    from its raw events."""
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            yield evt.name(), evt.start_ns() / 1e3, evt.duration_ns() / 1e3


def _parsed_device_events(prof):
    """The same, read from torch.profiler's parsed event tree: about 0.3
    ms per event to build."""
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            yield (evt.name, evt.time_range.start,
                   evt.time_range.end - evt.time_range.start)


def _device_tally(events, wall_s: float, wall_us: float) -> dict:
    """Device time by kernel row, the "other" row's by device kernel name
    (the longest OTHER_NAMES, names cut to OTHER_NAME_CHARS), busy time
    (the union of the events) and idle shares over the unprofiled
    (`wall_s`) and the profiled (`wall_us`) call; {} without events."""
    by_kernel, by_name, spans = {}, {}, []
    for name, start, us in events:
        spans.append((start, start + us))
        row = profiled_row(name)
        by_kernel[row] = by_kernel.get(row, 0.0) + us
        if row == "other":
            name = name[:OTHER_NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + us
    if not spans:
        return {}
    busy = _busy_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:OTHER_NAMES]
    return {"device_events": len(spans),
            "device_s": {k: v / 1e6 for k, v in by_kernel.items()},
            "other_by_name_s": {k: v / 1e6 for k, v in top},
            "device_busy_s": busy / 1e6,
            "idle_share": 1 - busy / (wall_s * 1e6),
            "idle_share_profiled": 1 - busy / wall_us}


def _profiled(run, args, activities):
    """`run(*args)` under torch.profiler, closed by a synchronise: (the
    profiler, wall µs, the end's perf_counter)."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    return prof, (t1 - t0) * 1e6, t1


def profiled_run(run, fresh=tuple, wall_s=None, crosscheck=False) -> dict:
    """`run(*fresh())` timed alone (unless the caller has just timed the
    same call and passes its `wall_s`), then under torch.profiler with the
    CUDA activity only (no row reads the host's op events, and a call of
    a million launches makes millions of them): `_device_tally` of the
    trace's raw events, launches, and `read_s`, the time from the profiled
    call's end to the end of the reading.  The device's idle share is one
    minus the union of device activity over the wall time of the call
    closed by a synchronise; the profiler slows the host's launches, so
    `idle_share` takes the unprofiled call's wall time and
    `idle_share_profiled` the profiled one's.  The raw events are read,
    not the parsed event tree, which takes about 0.3 ms per event to build
    (minutes for a call of a million launches).  `crosscheck` also reads
    the same trace's parsed event tree (`parsed_same_trace`) and profiles
    the call once more with the CPU and CUDA activities, read from the
    parsed tree (`cpu_and_cuda_parsed`): the recording and reading of the
    earlier profiles.  Where the profiler records no device activity,
    CUDA events around the whole call stand in, and the row says so.
    `fresh` makes the arguments outside the timed region."""
    from torch.profiler import ProfilerActivity

    if wall_s is None:
        args = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    args = fresh()
    _cuda.reset_counts()
    prof, wall_us, t1 = _profiled(run, args, [ProfilerActivity.CUDA])
    launches = {k: v for k, v in _cuda.counts().items() if v}
    tally = _device_tally(_raw_device_events(prof), wall_s, wall_us)
    out = {"wall_s": wall_s, "wall_profiled_s": wall_us / 1e6,
           "read_s": time.perf_counter() - t1, "launches": launches}
    if crosscheck:
        t2 = time.perf_counter()
        same = _device_tally(_parsed_device_events(prof), wall_s, wall_us)
        same["read_s"] = time.perf_counter() - t2
        old, old_us, t3 = _profiled(run, fresh(), [ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA])
        both = _device_tally(_parsed_device_events(old), wall_s, old_us)
        both.update(wall_profiled_s=old_us / 1e6,
                    read_s=time.perf_counter() - t3)
        out.update(parsed_same_trace=same, cpu_and_cuda_parsed=both)
    if tally:
        out.update(source="torch.profiler", **tally)
    else:
        args = fresh()
        t_a = torch.cuda.Event(enable_timing=True)
        t_b = torch.cuda.Event(enable_timing=True)
        t_a.record()
        run(*args)
        t_b.record()
        t_b.synchronize()
        out.update(source="cuda_events (the profiler saw no device "
                          "activity)",
                   events_s=t_a.elapsed_time(t_b) / 1e3)
    return out


def _witness(params, cs, device):
    """The proof's (Np, 16) standard-form witness limbs: numpy and device."""
    comp = cs.compiled()
    z_np = np.zeros((params.pk.a_query[0].shape[0], 16), np.uint32)
    z_np[:comp.num_vars] = ints_to_array(
        [v % P for v in cs.full_assignment()], 16)
    return z_np, to_torch(z_np, device)


def drain_profile(params, cs, device, cell="synthetic", witness=None):
    """`msm_a` and `msm_b_g2` of the proof once more, each through
    `profiled_run`: device time by kernel (K2-K5, K1, the rest) and idle
    share; in the synthetic cell `msm_a` also read the earlier way
    (`crosscheck`).  A query on the host is uploaded first, outside the
    timed calls; in big mode `msm_b_g2` is the half-split G2 MSM over the
    narrow query (`prove._g2_msm_big`), as in the proof."""
    pk = params.pk
    z_np, z_std = witness or _witness(params, cs, device)
    plan = msm_lm.make_dedup_plan(z_np)
    Np = pk.a_query[0].shape[0]
    c = prove._msm_c(Np)
    d = qap.domain_size(cs.n_constraints, cs.compiled().num_inputs)
    a_q = prove._consume(prove._put(pk.a_query, device))
    g2_q = prove._put(pk.b_g2_query, device)
    if d >= prove.BIG_DOMAIN:
        def g2():
            return prove._g2_msm_big(g2_q, z_std, plan, c, 1 << 17)
    else:
        g2_q = prove._consume(g2_q)

        def g2():
            return msm_lm.msm_lm_g2(*g2_q, z_std, c=c, dedup_plan=plan)
    for stage, run in (("msm_a", lambda: msm_lm.msm_lm(
            *a_q, z_std, c=c, dedup_plan=plan)), ("msm_b_g2", g2)):
        emit({"phase": "drain_profile", "cell": cell, "stage": stage,
              **profiled_run(run, crosscheck=cell == "synthetic"
                             and stage == "msm_a")})


def h_profile(params, cs, d, device, cell="synthetic", witness=None):
    """The proof's h phase (`compute_h_mont`: 7 NTTs and the pointwise
    products) once more on the proof's row evaluations, without the
    dedup-plan thread that runs beside it in the proof: first with the NTT
    tables dropped, so that it builds them as the proof's first h phase
    does (`cold_tables_s`), then through `profiled_run`."""
    z_mont = fr_field().to_mont((witness or _witness(params, cs, device))[1])
    dr = params.dev_r1cs

    def evs():
        return ([prove._pad_rows(p.eval(z_mont, dr.pal_mont), d)
                 for p in dr.row_plans],)

    def h(e):
        return prove.compute_h_mont(e, d)

    ntt_mod.clear_table_cache()
    args = evs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h(*args)
    del args
    torch.cuda.synchronize()
    emit({"phase": "h_profile", "cell": cell, "d": d,
          "cold_tables_s": time.perf_counter() - t0, **profiled_run(h, evs)})


def gen_mul_profile(device):
    """One `_gen_mul_am` chunk of GEN_CHUNK random scalars on G1 and one
    on G2 (the window tables already built), each through `profiled_run`:
    device time of K6/K7, K1's Fp multiply and inversion, and the rest by
    PyTorch kernel name (`_kernel_add`'s stacks and transposes, `_gather`,
    the affine conversion's); idle share."""
    gen = torch.Generator(device=device)
    gen.manual_seed(ROOT_SEED)
    scalars = random_field_limbs(fr_field(), keygen.GEN_CHUNK, gen, device)
    for kind in ("g1", "g2"):
        keygen._gen_mul_am(scalars, kind)  # the allocator's growth, untimed
        emit({"phase": "gen_mul_profile", "group": kind,
              "scalars": keygen.GEN_CHUNK,
              **profiled_run(lambda: keygen._gen_mul_am(scalars, kind))})


def require_launched(phase: str, names, launches: dict):
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise SystemExit(f"kernels not launched by the {phase}: {missing}")


def keygen_phase(log_d: int, device):
    """The 2^log_d key of the synthetic circuit, counted from a cold start
    (the window tables are built in it): spot-checked, proven under and
    verified; then the toy key against the committed file; then
    `gen_mul_profile`."""
    cs = SyntheticCircuit(constraints_for(log_d), ROOT_SEED)
    comp = cs.compiled()
    d = qap.domain_size(comp.n_constraints, comp.num_inputs)
    seed = b"bazuka-tpu-dev"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    record = {}
    t1 = time.perf_counter()
    params = keygen.generate_parameters(cs, seed=seed, device=device,
                                        record=record)
    torch.cuda.synchronize()
    total = time.perf_counter() - t1
    launches = _cuda.counts()
    sizes = _cuda.sizes()
    peak = torch.cuda.max_memory_allocated()
    requested = peak_requested()
    Np = params.pk.a_query[0].shape[0]

    t2 = time.perf_counter()
    samples, n_sampled = key_spot_check(comp, params, seed, d)
    check_s = time.perf_counter() - t2
    proof_record = {}
    t3 = time.perf_counter()
    proof = prove.create_proof(params, cs, r=1234567, s=7654321,
                               device=device, record=proof_record)
    torch.cuda.synchronize()
    proof_s = time.perf_counter() - t3
    x = cs.z[1]
    verdicts = (groth16_verify(params.vk, [x], proof),
                groth16_verify(params.vk, [(x + 1) % P], proof))
    del params
    torch.cuda.empty_cache()

    cs_toy, _ = toy_circuit()
    t4 = time.perf_counter()
    toy = keygen.generate_parameters(cs_toy, seed=b"test", device=device)
    toy_s = time.perf_counter() - t4
    toy_eq = key_equals_file(toy, TOY_KEY)
    checks = {
        **{f"toy_{k}": v for k, v in toy_eq.items()},
        **samples,
        "verify_accepts_x": verdicts[0],
        "verify_rejects_x_plus_1": not verdicts[1],
    }
    emit({"phase": "keygen", "log_d": log_d, "d": d,
          "Np": Np,
          "n_constraints": comp.n_constraints, "num_vars": comp.num_vars,
          "toy_s": toy_s, "stage_s": record["seconds"], "total_s": total,
          "max_memory_allocated": peak,
          "max_memory_requested": requested, "launches": launches,
          "add_sizes": {k: {str(n): c for (n, _), c in sorted(sizes[k].items())}
                        for k in FULL_ADD_NAMES},
          "rows_sampled": n_sampled, "spot_check_s": check_s,
          "proof_stage_s": proof_record["seconds"], "proof_total_s": proof_s,
          **checks})
    if not all(checks.values()):
        raise SystemExit(f"keygen failed its checks: {checks}")
    require_launched("keygen", KEYGEN_KERNELS, launches)
    gen_mul_profile(device)
    return launches, sizes


def mpn_transfers(users) -> list:
    """User i of n pays user i + 1 (mod n) 100 of MPN_TOKEN with a fee of
    7, nonce 1: the signed MPN transfers of phase 6's batch."""
    n = len(users)
    return [users[i].create_mpn_transaction(
        users[(i + 1) % n].get_mpn_address(), Money(MPN_TOKEN, 100),
        Money(MPN_TOKEN, 7), 1) for i in range(n)]


def mpn_update_batch(log4_tree: int = MPN_LOG4_TREE,
                     log4_token_tree: int = MPN_LOG4_TOKEN_TREE,
                     log4_batch: int = MPN_LOG4_BATCH):
    """The update batch of phase 6 at any size: 4^log4_batch users deposit
    1,000 of MPN_TOKEN each (one deposit batch, account indices
    registered), then user i pays user i + 1 (mod n) 100 with a fee of 7.
    Returns (UpdateCircuit, [commitment, height, state, aux_data,
    next_state], the n signed transfers)."""
    n = 1 << (2 * log4_batch)
    conf = MpnConfig(log4_tree, log4_token_tree, log4_batch, log4_batch,
                     log4_batch, MPN_CID)
    model = conf.state_model()
    db = RamKvStore()
    db.update([Put(db_keys.contract(str(MPN_CID)), ser.dumps(
        ZkContract(ZkCompressedState.empty(model), model)))])
    chain = MpnChainView(db)
    users = [TxBuilder(b"U%d" % i) for i in range(n)]
    deps = [u.deposit_mpn("", MPN_CID, u.get_mpn_address(), 1,
                          Money(MPN_TOKEN, 1000), Money.ziesha(0))
            for u in users]
    idx = {}
    deposit(MPN_CID, log4_tree, log4_token_tree, log4_batch, chain, deps,
            idx, check_balance=False)
    for addr, i in idx.items():
        chain.add_mpn_account_index(addr, i)
    txs = mpn_transfers(users)
    _, pubs, transitions = update(MPN_CID, log4_tree, log4_token_tree,
                                  log4_batch, MPN_TOKEN, chain, txs, {})
    commitment = prover_commitment(TxBuilder(b"WORKER").get_address(), 10)
    inputs = [commitment, *pubs.as_list()]
    circuit = UpdateCircuit(
        log4_tree, log4_token_tree, log4_batch, *inputs,
        fee_token=MPN_TOKEN.scalar,
        transitions=list(transitions) + [
            UpdateTransition.null(log4_tree, log4_token_tree)
            for _ in range(n - len(transitions))])
    return circuit, inputs, txs


def host_peak_rss() -> int:
    """Peak resident set of this process in bytes (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def counted(run):
    """`run()` with the launch counts set to 0 just before it and read
    just after: (result, (launches, sizes))."""
    _cuda.reset_counts()
    out = run()
    torch.cuda.synchronize()
    return out, (_cuda.counts(), _cuda.sizes())


def mem_total() -> int:
    """The host's MemTotal in bytes (/proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    return 0


# The worker's result, kept there until `mpn_host_send` is called, and
# its circuit, kept for its satisfaction check
_HOST_CS = {}


def mpn_host(log4_batch: int) -> None:
    """Phase 6's host half, in a worker process: the batch's witness and
    its circuit synthesised, kept in the worker for `mpn_host_send` and
    `mpn_host_check`: the circuit, the public inputs, the transfers and
    the stage seconds, with the host's MemTotal (read before synthesis)
    and this process's peak RSS."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    circuit, inputs, txs = mpn_update_batch(log4_batch=log4_batch)
    witness_s = time.perf_counter() - t0
    total = mem_total()
    t1 = time.perf_counter()
    cs = _HOST_CS["cs"] = synthesize_circuit(circuit)
    synthesis_s = time.perf_counter() - t1
    _HOST_CS["out"] = {"cs": cs, "inputs": inputs, "txs": txs,
            "transfers": len(circuit.transitions),
            "enabled": sum(t.enabled for t in circuit.transitions),
            "no_cryptography_module": "cryptography" not in sys.modules,
            "witness_gen_s": witness_s, "synthesis_s": synthesis_s,
            "mem_total": total, "host_peak_rss": host_peak_rss(),
            "done_at": time.time()}


def mpn_host_send() -> dict:
    """`mpn_host`'s result, sent when the main process asks for it: its
    unpickling there holds the main process's GIL for seconds (tens at
    256 transfers), which would stall whatever phase it lands in."""
    return _HOST_CS.pop("out")


def mpn_worker(pool, log4_batch: int):
    """Start `mpn_host` in `pool` (one process); returns (host, check):
    `host()` waits for the circuit, then has it sent (`worker_wait_s`,
    `transfer_s`) and queues the satisfaction check, which `check()` waits
    for before it ends the worker."""
    built = pool.apply_async(mpn_host, (log4_batch,))
    pending = {}

    def host():
        t0 = time.perf_counter()
        built.get()  # the worker's own error surfaces here
        t1 = time.perf_counter()
        sent = pool.apply_async(mpn_host_send)
        pending["check"] = pool.apply_async(mpn_host_check)
        out = sent.get()
        return {**out, "worker_wait_s": t1 - t0,
                "transfer_s": time.perf_counter() - t1}

    def check():
        out = pending.pop("check").get()
        pool.terminate()  # the worker's memory goes back to the host now
        return out

    return host, check


def mpn_host_check() -> dict:
    """The satisfaction check of `mpn_host`'s circuit, in the same worker
    after it, while the card makes the key."""
    cs = _HOST_CS.pop("cs")
    t0 = time.perf_counter()
    unsatisfied = cs.is_satisfied()
    return {"satisfied": unsatisfied is None,
            "satisfied_check_s": time.perf_counter() - t0,
            "host_peak_rss": host_peak_rss()}


def lower_for_small_run() -> dict:
    """Set SMALL_BIG_MODE's thresholds (big mode, the four-step, host
    residency) for a phase 6 at 4 transfers; returns them."""
    mods = {"prove": prove, "ntt": ntt_mod, "keygen": keygen}
    for name, value in SMALL_BIG_MODE.items():
        mod, attr = name.split(".")
        setattr(mods[mod], attr, value)
    return dict(SMALL_BIG_MODE)


def key_dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def fourstep_launches(sizes: dict) -> int:
    """Launches of the NTT's stage entry over rows (the four-step's)."""
    return sum(c for (_, row), c in sizes[fk.K_NTT.name].items() if row)


def mpn_key_reload(params, on_host, path: str, device, cell: str):
    """The key saved in the directory layout at `path` and loaded back
    memory-mapped under the default residency: head and VK equal to
    `params`'s, its host queries memory maps.  Returns the loaded key."""
    t0 = time.perf_counter()
    keygen.save_parameters(params, path)
    save_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    loaded = keygen.load_parameters(path, device=device)
    load_s = time.perf_counter() - t1
    key_checks = {
        "head_equal": keygen._pk_head(loaded) == keygen._pk_head(params),
        "vk_bytes_equal": ser.dumps(loaded.vk) == ser.dumps(params.vk),
        "host_queries_memory_mapped": all(
            isinstance(getattr(loaded.pk, n)[0], np.memmap)
            for n in on_host)}
    loaded.dev_r1cs = params.dev_r1cs
    emit({"phase": "mpn_key_save", "cell": cell, "save_s": save_s,
          "bytes_on_disk": key_dir_bytes(path), "load_s": load_s,
          **key_checks})
    if not all(key_checks.values()):
        raise SystemExit(f"MPN key did not load back: {key_checks}")
    return loaded


def mpn_phase(cell: str, host, check, log4_batch: int, device):
    """Phase 6, one cell of MPN_CELLS: the update batch from its witness
    (`mpn_host`'s result, which `host()` waits for; `check()` waits for
    the worker's satisfaction check, which runs while the card makes the
    key) to a key and two verified proofs under it.  The mainnet cell
    saves and reloads its key and proves under it on the host, then with
    every query on the card; `mpn_b64` proves twice under the key it made,
    then runs `sharded_phase` under it.  Returns ({"keygen", "proof",
    "proof_2" and for `mpn_b64` "sharded": (launch counts, sizes)}, the
    batch's signed transfers)."""
    (cell_batch, n_constraints, n_vars_pinned, inputs_pinned, key_seed,
     mainnet) = MPN_CELLS[cell]
    full = log4_batch == cell_batch
    asked_at = time.time()
    w = host()
    cs, inputs, txs = w.pop("cs"), w.pop("inputs"), w.pop("txs")
    n_vars = len(cs.assignment)
    comp = cs.compiled()
    d = qap.domain_size(cs.n_constraints, comp.num_inputs)
    checks = {"no_cryptography_module": w.pop("no_cryptography_module"),
              "enabled_transfers": w["enabled"] == w["transfers"]}
    if full:  # the sizes and inputs are pinned at the cell's batch only
        checks.update(
            n_constraints_pinned=cs.n_constraints == n_constraints,
            num_vars_pinned=n_vars == n_vars_pinned,
            public_inputs_equal_jax=tuple(inputs) == inputs_pinned)
    emit({"phase": "mpn_witness", "cell": cell,
          "log4_tree": MPN_LOG4_TREE,
          "log4_token_tree": MPN_LOG4_TOKEN_TREE, "log4_batch": log4_batch,
          "n_constraints": cs.n_constraints, "num_vars": n_vars, "d": d,
          "n_terms": [int(a.shape[0]) for a in comp.rows],
          "worker_done_ahead_s": asked_at - w.pop("done_at"),
          **w, "public_inputs": inputs, **checks})
    if not all(checks.values()):
        raise SystemExit(f"MPN witness failed its checks: {checks}")
    del comp

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    record = {}
    t3 = time.perf_counter()
    params, key_run = counted(lambda: keygen.generate_parameters(
        cs, seed=key_seed, device=device, record=record))
    key_s = time.perf_counter() - t3
    Np = params.pk.a_query[0].shape[0]
    residency = keygen.default_residency(Np)
    on_host = [n for n in QUERY_NAMES
               if isinstance(getattr(params.pk, n)[0], np.ndarray)]
    emit({"phase": "mpn_keygen", "cell": cell, "d": d, "Np": Np,
          "device_queries": residency, "queries_on_host": on_host,
          "total_s": key_s, "stage_s": record["seconds"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "max_memory_requested": peak_requested(),
          "host_peak_rss": host_peak_rss(), "launches": key_run[0]})
    require_launched("MPN keygen", KEYGEN_KERNELS, key_run[0])
    t_c = time.perf_counter()
    sat = check()
    emit({"phase": "mpn_satisfied", "cell": cell,
          "worker_wait_s": time.perf_counter() - t_c, **sat})
    if not sat["satisfied"]:
        raise SystemExit("the MPN circuit is not satisfied on the host")

    tmp = tempfile.mkdtemp(prefix="bazuka-mpn-key-") if mainnet else None
    try:
        if mainnet:
            path = os.path.join(tmp, "key")
            params = mpn_key_reload(params, on_host, path, device, cell)
        runs = [key_run]
        proof_bytes = {}
        tampered = inputs[:4] + [(inputs[4] + 1) % P]
        for r, s_, resident in ((7, 11, None), (8, 12, mainnet or None)):
            if resident:
                t6 = time.perf_counter()
                key = keygen.load_parameters(path, device=device,
                                             device_queries=True)
                load_s = time.perf_counter() - t6
                key.dev_r1cs = params.dev_r1cs
            else:
                key, load_s = params, None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            rec = {}
            t7 = time.perf_counter()
            proof, run = counted(lambda: prove.create_proof(
                key, cs, r=r, s=s_, device=device, record=rec))
            total = time.perf_counter() - t7
            runs.append(run)
            proof_bytes.setdefault("first", ser.dumps(proof))
            verdicts = {
                "verify_accepts": groth16_verify(key.vk, inputs, proof),
                "verify_rejects_next_state_plus_1":
                not groth16_verify(key.vk, tampered, proof),
                "big_mode_iff_mainnet": rec["big_mode"] == mainnet}
            if mainnet:
                verdicts["fourstep_ran"] = fourstep_launches(run[1]) > 0
            emit({"phase": "mpn_proof", "cell": cell, "r": r, "s": s_,
                  "device_queries": resident or residency,
                  "resident_load_s": load_s, "total_s": total,
                  "stage_s": rec["seconds"], "in_big_mode": rec["big_mode"],
                  "n_heavy_vals": rec["n_heavy_vals"],
                  "memory_allocated_at_start": base,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "max_memory_requested": peak_requested(),
                  "host_peak_rss": host_peak_rss(), "launches": run[0],
                  "fourstep_stage_launches": fourstep_launches(run[1]),
                  **verdicts})
            if not all(verdicts.values()):
                raise SystemExit(f"MPN proof failed its checks: {verdicts}")
            del key
        require_launched("MPN proof", PROOF_KERNELS, runs[1][0])
        witness = _witness(params, cs, device)
        h_profile(params, cs, d, device, cell=cell, witness=witness)
        drain_profile(params, cs, device, cell=cell, witness=witness)
        del witness
        named = dict(zip(("keygen", "proof", "proof_2"), runs))
        if not mainnet:  # the 64-transfer cell is proven over a mesh too
            named["sharded"] = sharded_phase(
                params, cs, inputs, proof_bytes["first"],
                SHARDED_LOG_NS if full else SMALL_SHARDED_LOG_NS, device)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    return named, txs


# The `sharded` phase, inside `mpn_b64`: the sharded prover of
# `bazuka_tpu_torch/parallel/` with SHARDS shards on the one card (a
# correctness gate: the shards run one after another, so its seconds are
# the cost of sharding on one card, not a speed over several), the
# four-step over that mesh at 2^SHARDED_LOG_NS (below --log-d 22 at
# 2^SMALL_SHARDED_LOG_NS); phase 8 verifies the mainnet block over
# EDDSA_SHARDS shards.
SHARDS, EDDSA_SHARDS = 4, 2
SHARDED_LOG_NS, SMALL_SHARDED_LOG_NS = (22, 24), (16, 18)


def one_card_mesh(n_shards: int):
    """n_shards shards, all on card 0."""
    return parallel.make_mesh(n_shards, ["cuda:0"])


def fourstep_checks(mesh, log_ns, device) -> list:
    """`parallel.ntt_four_step` over the mesh on 2^log_n random canonical
    limbs, forward and inverse, twice each (the first call at its size and
    direction builds its row tables: `cold_s`), against `ops.ntt.ntt_mont`
    on the card; one row per size and direction."""
    F = fr_field()
    gen = torch.Generator(device=device)
    gen.manual_seed(ROOT_SEED)
    rows = []
    for log_n in log_ns:
        x = random_field_limbs(F, 1 << log_n, gen, device)
        for inverse in (False, True):
            seconds = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = parallel.ntt_four_step(mesh, x, inverse)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            got = parallel.gather_rows(out, device)
            del out
            rows.append({"log_n": log_n, "inverse": inverse,
                         "cold_s": seconds[0], "warm_s": seconds[1],
                         "equal_ntt_mont": torch.equal(
                             got, ntt_mod.ntt_mont(x, inverse))})
            del got
        del x
    return rows


def host_resident(params):
    """`params` with its five queries as host numpy arrays (uint16 limbs,
    uint8 flags), the rest shared."""
    pk = dataclasses.replace(params.pk, **{
        n: keygen._narrow(getattr(params.pk, n)) for n in QUERY_NAMES})
    return keygen.Parameters(pk=pk, vk=params.vk, dev_r1cs=params.dev_r1cs)


def sharded_phase(params, cs, inputs, want: bytes, log_ns, device):
    """The `sharded` phase: `fourstep_checks` over SHARDS shards on the
    card, then `create_proof_sharded` of the cell's batch at r, s = 7, 11
    over the same mesh under the cell's key, its queries narrow on the
    card, then the same proof with them on the host: each proof's bytes
    equal `want` (the cell's single-device proof at 7, 11), accepted for
    the public inputs, rejected with next_state + 1, K1-K5 launched.
    Returns (launch counts, sizes) of all its runs."""
    mesh = one_card_mesh(SHARDS)
    t0 = time.perf_counter()
    fs, fs_run = counted(lambda: fourstep_checks(mesh, log_ns, device))
    emit({"phase": "sharded_fourstep", "shards": [str(x) for x in mesh],
          "runs": fs, "launches": fs_run[0],
          "stage_entry_sizes": size_rows(fs_run[1][fk.K_NTT.name])})
    if not all(r["equal_ntt_mont"] for r in fs):
        raise SystemExit("the four-step over the mesh disagrees with "
                         "ntt_mont")
    require_launched("sharded four-step", (fk.K_FR.name, fk.K_NTT.name),
                     fs_run[0])
    runs = [fs_run]
    tampered = inputs[:4] + [(inputs[4] + 1) % P]
    for where, key in (("card", params), ("host", host_resident(params))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rec = {}
        t1 = time.perf_counter()
        proof, run = counted(lambda: parallel.create_proof_sharded(
            key, cs, mesh, r=7, s=11, record=rec))
        total = time.perf_counter() - t1
        runs.append(run)
        checks = {
            "bytes_equal_single_device": ser.dumps(proof) == want,
            "verify_accepts": groth16_verify(key.vk, inputs, proof),
            "verify_rejects_next_state_plus_1":
            not groth16_verify(key.vk, tampered, proof)}
        emit({"phase": "sharded", "queries": where, "shards": rec["shards"],
              "r": 7, "s": 11, "total_s": total, "stage_s": rec["seconds"],
              "n_heavy_vals": rec["n_heavy_vals"],
              "memory_allocated_at_start": base,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "max_memory_requested": peak_requested(),
              "host_peak_rss": host_peak_rss(), "launches": run[0],
              "fourstep_stage_launches": fourstep_launches(run[1]),
              "k3_lanes": size_rows(run[1][ck.K_G1_ADD.name]),
              "k5_lanes": size_rows(run[1][ck.K_G2_ADD.name]), **checks})
        if not all(checks.values()):
            raise SystemExit(f"sharded proof failed its checks: {checks}")
        require_launched("sharded proof", PROOF_KERNELS, run[0])
    emit({"phase": "sharded_total", "seconds": time.perf_counter() - t0})
    return merge_phases(*runs)


# ------------------------------------------------ Poseidon and JubJub EdDSA


def size_rows(sizes: dict) -> list:
    """A kernel's {(n, extra): launches} as sorted [n, extra, launches]."""
    return [[n, extra, c] for (n, extra), c in sorted(sizes.items())]


def merkle_levels(leaves):
    """The levels of a dense 4-ary tree over (4^k, 16) Montgomery leaf
    limbs, each hashed in one call: [leaves, level 1, ..., root (1, 16)]."""
    levels = [leaves]
    while levels[-1].shape[0] > 1:
        levels.append(poseidon_batch_mont(
            levels[-1].reshape(-1, 4, FR_LIMBS)))
    return levels


def host_hashes_agree(groups, hashes) -> bool:
    """(n, arity, 16) Montgomery inputs and their (n, 16) hashes against
    the host Poseidon."""
    F = fr_field()
    ins, outs = F.decode(groups.cpu()), F.decode(hashes.cpu())
    return all(poseidon([int(v) for v in row]) == int(h)
               for row, h in zip(ins, outs))


def sample(n: int, k: int, rng):
    """Up to k distinct random indices below n, sorted."""
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def plain_mul(a, b):
    """Kernel K1's plain version over Fr, on the operands' device."""
    return fk.mont_mul_plain(fr_field(), a, b)


def tree_checks(levels, rng, n_first: int = 1024, small: int = 4096):
    """A tree from `merkle_levels`, limb for limb against the same hash
    with the plain multiply (`plain_mul`, on the levels' device: the plain
    path) on the bottom level's first n_first hashes and on every level of
    at most `small` hashes; then HOST_ROWS random bottom-level hashes and
    every hash on one random leaf's path to the root against the host
    Poseidon.  Returns ({check: bool}, hashes held to the plain path)."""
    ins, outs = [], []
    for k in range(1, len(levels)):
        n = levels[k].shape[0]
        if n > small:
            n = n_first if k == 1 else 0
        ins.append(levels[k - 1][:4 * n].reshape(n, 4, FR_LIMBS))
        outs.append(levels[k][:n])
    # one plain call over every level's checked hashes
    plain = poseidon_batch_mont(torch.cat(ins), mul=plain_mul)
    cpu = [lv.cpu() for lv in levels]
    groups = cpu[0].reshape(-1, 4, FR_LIMBS)
    rows = torch.from_numpy(sample(groups.shape[0], HOST_ROWS, rng))
    leaf = int(rng.integers(cpu[0].shape[0]))
    path = [host_hashes_agree(
                cpu[k - 1].reshape(-1, 4, FR_LIMBS)[None, leaf >> 2 * k],
                cpu[k][None, leaf >> 2 * k])
            for k in range(1, len(cpu))]
    return {"tree_plain_equal": torch.equal(plain, torch.cat(outs)),
            "tree_host_sampled": host_hashes_agree(groups[rows],
                                                   cpu[1][rows]),
            "tree_root_path": all(path),
            "tree_one_root": tuple(cpu[-1].shape) == (1, FR_LIMBS)
            }, plain.shape[0]


def poseidon_phase(log4_leaves: int, log2_batch: int, device):
    """Phase 7: the 16 golden vectors, a dense 4-ary tree of 4^log4_leaves
    random leaves hashed level by level (one call per level), and one flat
    batch of 2^log2_batch random arity-4 hashes, all on the card and
    checked; then the batch under torch.profiler.  Returns (launch counts,
    sizes)."""
    F = fr_field()
    gen = torch.Generator(device=device)
    gen.manual_seed(ROOT_SEED)
    rng = np.random.default_rng(ROOT_SEED)
    leaves = random_field_limbs(F, 4 ** log4_leaves, gen, device)
    batch = random_field_limbs(F, 4 << log2_batch, gen, device).view(
        -1, 4, F.n)
    torch.cuda.synchronize()
    # what earlier phases left allocated (cached tables) is in every peak
    resident = torch.cuda.memory_allocated()
    _cuda.reset_counts()
    t0 = time.perf_counter()
    golden = [int(poseidon_batch(np.array([list(range(a))], dtype=object),
                                 device=device)[0])
              for a in range(1, len(POSEIDON_GOLDEN) + 1)]
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    levels = merkle_levels(leaves)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tree_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t3 = time.perf_counter()
    out = poseidon_batch_mont(batch)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    batch_peak = torch.cuda.max_memory_allocated()
    launches, sizes = _cuda.counts(), _cuda.sizes()

    t5 = time.perf_counter()
    checks, n_plain = tree_checks(levels, rng)
    checks["golden"] = golden == list(POSEIDON_GOLDEN)
    rows = torch.from_numpy(sample(batch.shape[0], HOST_ROWS, rng))
    checks["batch_host_sampled"] = host_hashes_agree(batch.cpu()[rows],
                                                     out.cpu()[rows])
    n_tree = sum(lv.shape[0] for lv in levels[1:])
    products = poseidon_products(5)
    emit({"phase": "poseidon", "phase_s": time.perf_counter() - t0,
          "golden_s": t1 - t0,
          "tree_leaves": leaves.shape[0], "tree_hashes": n_tree,
          "tree_calls": len(levels) - 1, "tree_s": t2 - t1,
          "tree_hashes_per_s": n_tree / (t2 - t1),
          "tree_max_memory_allocated": tree_peak,
          "batch_hashes": batch.shape[0], "batch_s": t4 - t3,
          "batch_hashes_per_s": batch.shape[0] / (t4 - t3),
          "batch_max_memory_allocated": batch_peak,
          "memory_allocated_at_start": resident,
          "fr_products_per_hash": products,
          "imads_per_hash": product_imads(products),
          "bound_hashes_per_s": rate_bound(products),
          "launches": launches,
          "k1_fr_sizes": size_rows(sizes[fk.K_FR.name]),
          "plain_checked_hashes": n_plain,
          "check_s": time.perf_counter() - t5, **checks})
    if not all(checks.values()):
        raise SystemExit(f"Poseidon failed its checks: {checks}")
    require_launched("poseidon", (fk.K_FR.name,), launches)
    emit({"phase": "poseidon_profile", "hashes": batch.shape[0],
          **profiled_run(lambda: poseidon_batch_mont(batch),
                         wall_s=t4 - t3)})
    return launches, sizes


def _signed_row(i: int):
    """Row i of the EdDSA batch: (public key, its affine point, the
    signature of EDDSA_MSG0 + i) under the key of seed b"E%d" % i."""
    pub, sk = jj.JubJub.generate_keys(b"E%d" % i)
    return pub, sk.public_point, jj.JubJub.sign(sk, EDDSA_MSG0 + i)


def _plain_call(job):
    """One of the EdDSA phase's calls on CPU tensors (the plain path), on
    one intra-op thread: its tensors are a few KiB, and the three calls
    run side by side in worker processes."""
    torch.set_num_threads(1)
    name, args = job
    if name == "verify":
        return batch_eddsa_verify(*args, device="cpu")
    mul = batch_base_mul if name == "base_mul" else batch_scalar_mul
    return mul(fr_field(), *args)


def eddsa_batch(n: int, pmap=map) -> dict:
    """n rows signed on the host (`pmap` over `_signed_row`), every 8th
    row tampered with in turn by EDDSA_TAMPER: the message + 1, s + 1, the
    next row's key, R + B for R, and R off the curve.  Returns lists "pub"
    (compressed keys), "pks" (affine keys), "msgs", "sigs", "tamper" (the
    kind or None) and the expected verdicts "expected"."""
    pub, pks, sigs = (list(c) for c in zip(*pmap(_signed_row, range(n))))
    msgs = [EDDSA_MSG0 + i for i in range(n)]
    tamper = [None] * n
    for i in range(0, n, 8):
        kind = tamper[i] = EDDSA_TAMPER[(i // 8) % len(EDDSA_TAMPER)]
        r, s = sigs[i].r, sigs[i].s
        if kind == "msg_plus_1":
            msgs[i] += 1
        elif kind == "s_plus_1":
            sigs[i] = jj.Signature(r, s + 1)
        elif kind == "other_pk":
            pub[i], pks[i] = pub[(i + 1) % n], pks[(i + 1) % n]
        elif kind == "other_r_on_curve":
            sigs[i] = jj.Signature(jj.point_add(r, jj.BASE), s)
        else:
            sigs[i] = jj.Signature((r[0], (r[1] + 1) % jj.P), s)
    return {"pub": pub, "pks": pks, "msgs": msgs, "sigs": sigs,
            "tamper": tamper,
            "expected": np.array([t is None for t in tamper])}


def eddsa_checks(batch: dict, verdicts, rng) -> dict:
    """Verdicts of `batch_eddsa_verify` on an `eddsa_batch` against the
    ones expected from its construction, and against the host
    `JubJub.verify` on every tampered row and HOST_ROWS random valid
    rows."""
    exp = batch["expected"]
    valid = np.flatnonzero(exp)
    rows = np.sort(np.concatenate([np.flatnonzero(~exp),
                                   valid[sample(len(valid), HOST_ROWS,
                                                rng)]]))
    host = [jj.JubJub.verify(batch["pub"][i], batch["msgs"][i],
                             batch["sigs"][i]) for i in rows]
    return {"verdicts_expected": bool(np.array_equal(verdicts, exp)),
            "host_agrees": host == [bool(verdicts[i]) for i in rows]}


def transfer_args(txs) -> tuple:
    """`batch_eddsa_verify`'s arguments for signed MPN transfers: each
    sender's key, the transfer's hash, its signature."""
    return ([tx.src_pub_key.decompress() for tx in txs],
            [tx.hash() for tx in txs], [tx.sig for tx in txs])


def mul_scalars(n: int, rng) -> list:
    """n scalars for the multiplies alone: 0, 1, ORDER − 1 and ORDER, then
    random values below p (all 255 bits)."""
    edge = [0, 1, jj.ORDER - 1, jj.ORDER]
    return (edge + [int.from_bytes(rng.bytes(32), "little") % jj.P
                    for _ in range(n - len(edge))])[:n]


def mul_checks(scalars, pks, sb, sp, rows) -> dict:
    """`batch_base_mul` (sb) and `batch_scalar_mul` of the points pks (sp)
    against the host `point_mul` on the given rows."""
    F = fr_field()
    idx = torch.tensor(rows, device=sb[0].device)
    got_b = to_affine_host(F, tuple(c[idx] for c in sb))
    got_s = to_affine_host(F, tuple(c[idx] for c in sp))
    return {"base_mul_host": list(got_b) == [
                jj.point_mul(jj.BASE, scalars[i]) for i in rows],
            "scalar_mul_host": list(got_s) == [
                jj.point_mul(pks[i], scalars[i]) for i in rows]}


# The EdDSA phase's worker processes: the signing of its n rows (about
# 8 ms of host time each) and the plain path's three calls.  A fixed
# count, so that the host's memory does not grow with its cores.
HOST_WORKERS = 4


def eddsa_phase(n: int, block, device):
    """Phase 8: one mainnet block, phase 6's signed transfers, verified in
    one call (the headline); n signatures made on the host (every 8th
    tampered), verified in one call; then `batch_base_mul` and
    `batch_scalar_mul` alone on n scalars; the block's verification under
    torch.profiler; the block over EDDSA_SHARDS shards, every 8th message
    + 1 (`parallel.eddsa_verify_sharded`); then the same three calls on
    CPU copies of the first PLAIN_ROWS rows in worker processes while
    this one checks the verdicts and products against the host.  Returns
    (launch counts, sizes) of the phase and of its sharded call."""
    F = fr_field()
    rng = np.random.default_rng(ROOT_SEED)
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(HOST_WORKERS) as pool:
        t1 = time.perf_counter()
        batch = eddsa_batch(n, functools.partial(pool.map, chunksize=32))
        sign_s = time.perf_counter() - t1
        args = (batch["pks"], batch["msgs"], batch["sigs"])
        block_args = transfer_args(block)
        scalars = mul_scalars(n, rng)
        s_std = F.encode(np.array(scalars, dtype=object), mont=False,
                         device=device)
        pts = to_extended(F, *(F.encode(np.array([p[c] for p in args[0]],
                                                 dtype=object), device=device)
                               for c in (0, 1)))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        _cuda.reset_counts()
        t3 = time.perf_counter()
        block_ok = batch_eddsa_verify(*block_args, device=device)
        t4 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        verdicts = batch_eddsa_verify(*args, device=device)
        t5 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        sb = batch_base_mul(F, s_std)
        sp = batch_scalar_mul(F, pts, s_std)
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        launches, sizes = _cuda.counts(), _cuda.sizes()
        require_launched("eddsa", (fk.K_FR.name,), launches)
        profile = profiled_run(
            lambda: batch_eddsa_verify(*block_args, device=device),
            wall_s=t4 - t3)
        # the block over EDDSA_SHARDS shards, every 8th message + 1
        pks_b, msgs_b, sigs_b = block_args
        msgs_t = [(m + 1) % P if i % 8 == 0 else m
                  for i, m in enumerate(msgs_b)]
        t_s = time.perf_counter()
        sharded_ok, sharded_run = counted(
            lambda: parallel.eddsa_verify_sharded(
                one_card_mesh(EDDSA_SHARDS), pks_b, msgs_t, sigs_b))
        sharded_s = time.perf_counter() - t_s
        require_launched("sharded eddsa", (fk.K_FR.name,), sharded_run[0])

        # the plain path runs in three workers while this process checks
        t7 = time.perf_counter()
        m = min(PLAIN_ROWS, n)
        s_cpu = s_std[:m].cpu()
        plain = pool.map_async(_plain_call, [
            ("verify", tuple(a[:m] for a in args)),
            ("base_mul", (s_cpu,)),
            ("scalar_mul", (tuple(c[:m].cpu() for c in pts), s_cpu))],
            chunksize=1)
        checks = {"block_all_true": len(block_ok) == len(block)
                  and bool(block_ok.all()),
                  "sharded_verdicts_expected": bool(np.array_equal(
                      sharded_ok, np.arange(len(block)) % 8 != 0))}
        checks.update(eddsa_checks(batch, verdicts, rng))
        # the four edge scalars and HOST_ROWS random others
        rows = list(range(min(4, n))) + (
            sample(max(n - 4, 0), HOST_ROWS, rng) + 4).tolist()
        checks.update(mul_checks(scalars, args[0], sb, sp, rows))
        check_s = time.perf_counter() - t7
        plain_v, plain_sb, plain_sp = plain.get()
        plain_s = time.perf_counter() - t7
    checks.update(
        plain_verify_equal=bool(np.array_equal(plain_v, verdicts[:m])),
        plain_base_mul_equal=all(torch.equal(a[:m].cpu(), b)
                                 for a, b in zip(sb, plain_sb)),
        plain_scalar_mul_equal=all(torch.equal(a[:m].cpu(), b)
                                   for a, b in zip(sp, plain_sp)))
    bound = rate_bound(EDDSA_PRODUCTS)
    emit({"phase": "eddsa", "phase_s": time.perf_counter() - t0,
          "block_transfers": len(block),
          "block_verify_s": t4 - t3,
          "block_verifies_per_s": len(block) / (t4 - t3),
          "fr_products_per_verify": EDDSA_PRODUCTS,
          "imads_per_verify": product_imads(EDDSA_PRODUCTS),
          "bound_verifies_per_s": bound,
          "block_bound_s": len(block) / bound,
          "signatures": n, "tampered": int((~batch["expected"]).sum()),
          "sign_host_s": sign_s, "host_workers": HOST_WORKERS,
          "verify_s": t5 - t4, "verifies_per_s": n / (t5 - t4),
          "max_memory_allocated": peak,
          "memory_allocated_at_start": resident, "muls_alone_s": t6 - t5,
          "launches": launches,
          "k1_fr_sizes": size_rows(sizes[fk.K_FR.name]),
          "check_s": check_s, "plain_rows": m, "plain_s": plain_s,
          "sharded_shards": EDDSA_SHARDS, "sharded_verify_s": sharded_s,
          "sharded_tampered": int((~sharded_ok).sum()),
          "sharded_launches": sharded_run[0], **checks})
    if not all(checks.values()):
        raise SystemExit(f"EdDSA failed its checks: {checks}")
    emit({"phase": "eddsa_profile", "signatures": len(block), **profile})
    return (launches, sizes), sharded_run


# ------------------------------------------------------------ the dev chain


# The `devchain` phase: the node's block production
# (bazuka_tpu/node/heartbeat.py:248-276, without the network) on the --dev
# chain of config/blockchain.py's `get_dev_blockchain_config`, at
# mainnet's tree shapes (log4_tree 15, log4_token_tree 3) and batches of
# 4^DEV_LOG4_BATCH (mainnet's are 64 / 64 / 256).  Batches of 16
# (DEV_LOG4_BATCH = 2) took the phase 163-179 s on one H100 and would
# bring the whole run to about its 1,200 s limit on the slowest host
# measured (PERF.md §5); batches of 4 leave it room.  Users b"D0".. fill
# a batch but for the slot of the validator's reward self-deposit: each
# holds DEV_L1_FUNDS on L1 and deposits DEV_DEPOSIT in block 1; in block 2
# user i pays user i + 1 DEV_PAY with a fee of DEV_FEE, and the first half
# of them withdraw DEV_WITHDRAW to their L1 address.  All in Ziesha.
DEV_LOG4_TREE, DEV_LOG4_TOKEN_TREE = 15, 3
DEV_LOG4_BATCH = 1
DEV_L1_FUNDS, DEV_DEPOSIT, DEV_PAY, DEV_FEE, DEV_WITHDRAW = (
    10_000, 1_000, 100, 7, 50)
DEV_CIRCUITS = {"deposit": (DepositCircuit, DepositTransition),
                "withdraw": (WithdrawCircuit, WithdrawTransition),
                "update": (UpdateCircuit, UpdateTransition)}
# The port's names the dev chain's flow uses; the tests hand `DevChain`
# the JAX package's under the same names.
PORT = types.SimpleNamespace(
    KvStoreChain=KvStoreChain, RamKvStore=RamKvStore, TxBuilder=TxBuilder,
    Money=Money, ContractId=ContractId, Ratio=Ratio, MpnWorker=MpnWorker,
    prepare_works=prepare_works, ser=ser, Block=Block, errors=chain_errors)


class DevChain:
    """The validator's side of the dev chain's blocks: a `KvStoreChain`
    over a `RamKvStore` on `conf`, users b"D0".. funded on L1 (as
    tests/test_mpn_pipeline.py funds its validator) and the validator
    b"DEV-VALIDATOR" registered as a staker (the dev genesis has none; no
    one delegates to it, so it is paid the whole reward), then
    per block: `prepare_works` with the node's rewards (the validator's
    reward, 5 / 5 / 15 % of it per deposit / withdraw / update batch) and
    one registered worker b"WORKER"; the proofs handed to `pool.prove` by
    the caller; `ready`, `draft_block`, `apply_block`.  `lib` names the
    package (PORT, or the JAX package's names in the tests); `store` is
    the chain's store (a `RamKvStore` if None) and `validator` the
    validator's `TxBuilder` (b"DEV-VALIDATOR"'s if None)."""

    def __init__(self, conf, lib=PORT, store=None, validator=None):
        self.lib, self.conf = lib, conf
        self.cid = conf.mpn_config.mpn_contract_id
        self.chain = lib.KvStoreChain(store or lib.RamKvStore(), conf)
        self.validator = validator or lib.TxBuilder(b"DEV-VALIDATOR")
        self.worker = lib.TxBuilder(b"WORKER")
        n = (1 << (2 * conf.mpn_config.log4_deposit_batch_size)) - 1
        self.users = [lib.TxBuilder(b"D%d" % i) for i in range(n)]
        self.withdrawers = self.users[:(n + 1) // 2]
        self.rewards = []
        zsh = lib.ContractId.ZIESHA
        for u in self.users:
            self.chain._set_balance(u.get_address(), zsh, DEV_L1_FUNDS)
        v = self.validator.get_address()
        self.chain.apply_tx(self.validator.register_validator(
            "", lib.Ratio(12), lib.Money.ziesha(0),
            self.chain.get_nonce(v) + 1).tx)

    def stake(self, amount: int):
        """The validator delegates `amount` Ziesha to itself, funded on L1
        for it: with a stake, `validator_status` gives it a VRF proof (the
        one staker of the dev genesis, it is elected in every slot); its
        L1 balance is all it changes of `expected()`."""
        v, lib = self.validator, self.lib
        self.chain._set_balance(v.get_address(), lib.ContractId.ZIESHA,
                                amount)
        self.chain.apply_tx(v.delegate(
            "", v.get_address(), amount, lib.Money.ziesha(0),
            self.chain.get_nonce(v.get_address()) + 1).tx)

    def mpn_txs(self, block: int):
        """(deposits, withdraws, transfers) of block 1 or 2."""
        zsh, chain, users = self.lib.Money.ziesha, self.chain, self.users
        if block == 1:
            return [u.deposit_mpn(
                "", self.cid, u.get_mpn_address(),
                chain.get_deposit_nonce(u.get_address(), self.cid) + 1,
                zsh(DEV_DEPOSIT), zsh(0)) for u in users], [], []
        acc = {str(u.get_mpn_address()):
               chain.get_mpn_account(u.get_mpn_address()) for u in users}
        n = len(users)
        withdraws = [u.withdraw_mpn(
            "", self.cid, acc[str(u.get_mpn_address())].withdraw_nonce + 1,
            zsh(DEV_WITHDRAW), zsh(0), u.get_address())
            for u in self.withdrawers]
        pays = [users[i].create_mpn_transaction(
            users[(i + 1) % n].get_mpn_address(), zsh(DEV_PAY), zsh(DEV_FEE),
            acc[str(users[i].get_mpn_address())].tx_nonce + 1)
            for i in range(n)]
        return [], withdraws, pays

    def prepare(self, block: int):
        v = self.validator.get_address()
        reward = self.chain.min_validator_reward(v)
        self.rewards.append(reward)
        return self.lib.prepare_works(
            self.conf.mpn_config, self.chain,
            {"worker": self.lib.MpnWorker(self.worker.get_address())},
            *self.mpn_txs(block), reward, reward // 100 * 5,
            reward // 100 * 5, reward // 100 * 15,
            self.chain.get_deposit_nonce(v, self.cid),
            self.validator, self.validator)

    def draft(self, pool, block: int):
        """(the pool's update transaction, the drafted block)."""
        td = pool.ready(self.validator, self.chain.get_nonce(
            self.validator.get_address()) + 1)
        if td is None:
            raise SystemExit("the work pool is not ready")
        blk = self.chain.draft_block(block * self.conf.slot_duration, [td],
                                     self.validator)
        if blk is None or len(blk.body) != 1:
            raise SystemExit("the dev chain drafted no block of the "
                             "pool's update")
        return td, blk

    def tampered_block(self, blk, proof):
        """`blk` with the last update's proof replaced by `proof`, signed
        again and its merkle root recomputed: only the proof is wrong."""
        lib = self.lib
        bad = lib.ser.loads(lib.Block, lib.ser.dumps(blk))
        tx = bad.body[0]
        tx.data.updates[-1].proof = proof
        self.validator.sign_tx(tx)
        bad.header.block_root = bad.merkle_tree().root()
        return bad

    def refuses(self, blk) -> bool:
        """True iff applying `blk` on a fork raises IncorrectZkProof."""
        try:
            self.chain.isolated(lambda c: c.apply_block(blk))
        except self.lib.errors.IncorrectZkProof:
            return True
        return False

    def expected(self, blocks: int = 2) -> dict:
        """Each user's MPN and L1 Ziesha, the validator's MPN Ziesha, the
        worker's L1 rewards and the contract's height that the first
        `blocks` blocks (1 or 2) give by construction."""
        w = {str(u.get_address()) for u in self.withdrawers}
        paid = DEV_WITHDRAW if blocks == 2 else 0
        fee = DEV_FEE if blocks == 2 else 0
        rewards = self.rewards[:blocks]
        return {
            "mpn": [DEV_DEPOSIT - fee
                    - (paid if str(u.get_address()) in w else 0)
                    for u in self.users],
            "l1": [DEV_L1_FUNDS - DEV_DEPOSIT
                   + (paid if str(u.get_address()) in w else 0)
                   for u in self.users],
            "validator_mpn": sum(r - 2 * (r // 100 * 5) - r // 100 * 15
                                 for r in rewards),
            "worker_l1": sum(2 * (r // 100 * 5) + r // 100 * 15
                             for r in rewards),
            "contract_height": 1 + len(rewards)}

    def state(self) -> dict:
        """The same values as the chain reads them."""
        chain, zsh = self.chain, self.lib.ContractId.ZIESHA

        def mpn(b):
            acc = chain.get_mpn_account(b.get_mpn_address())
            return sum(m.amount for m in acc.tokens.values()
                       if m.token_id == zsh)
        return {
            "mpn": [mpn(u) for u in self.users],
            "l1": [chain.get_balance(u.get_address(), zsh)
                   for u in self.users],
            "validator_mpn": mpn(self.validator),
            "worker_l1": chain.get_balance(self.worker.get_address(), zsh),
            "contract_height":
            chain.get_contract_account(self.cid).height}


def work_circuit(work, prover):
    """The circuit of an `MpnWork` that the prover `prover` (an address)
    proves: its commitment `prover_commitment(prover, work.reward)`, the
    work's public inputs, its transitions padded with the kind's null
    transition, and for the update the fee token Ziesha (the reference's
    external prover builds it; the JAX package has no such function).
    Returns (circuit, [commitment, height, state, aux_data, next_state])."""
    mc, pi = work.config, work.public_inputs
    cls, transition = DEV_CIRCUITS[work.data_kind]
    log4_batch = {"deposit": mc.log4_deposit_batch_size,
                  "withdraw": mc.log4_withdraw_batch_size,
                  "update": mc.log4_update_batch_size}[work.data_kind]
    inputs = [prover_commitment(prover, work.reward), *pi.as_list()]
    pad = (1 << (2 * log4_batch)) - len(work.transitions)
    extra = ({"fee_token": ContractId.ZIESHA.scalar}
             if work.data_kind == "update" else {})
    circuit = cls(mc.log4_tree_size, mc.log4_token_tree_size, log4_batch,
                  *inputs, transitions=list(work.transitions) + [
                      transition.null(mc.log4_tree_size,
                                      mc.log4_token_tree_size)
                      for _ in range(pad)], **extra)
    return circuit, inputs


def negated_a(proof):
    """A Groth16 `ZkProof` with A moved to −A (a dummy one: a dummy proof
    that fails)."""
    if proof.kind == "dummy":
        return ZkProof.dummy(False)
    p = proof.proof
    a = G1Wire(p.a.x, (-p.a.y) % bls.P, p.a.infinity)
    return ZkProof.groth16(dataclasses.replace(p, a=a))


def wire_copy(conf):
    """A copy of the dev chain's config whose three VKs went through the
    wire codec (`encode_vk`, `decode_vk`), in its MPN config and in the
    genesis's contract, and whether the contract id (a hash of the
    genesis transaction's bytes, the VKs among them) came out equal."""
    c = copy.deepcopy(conf)
    contract = c.genesis.body[1].data.contract
    for name, funcs in (("deposit", contract.deposit_functions),
                        ("withdraw", contract.withdraw_functions),
                        ("update", contract.functions)):
        vk = ZkVerifierKey.groth16(decode_vk(encode_vk(
            getattr(c.mpn_config, f"{name}_vk").vk)))
        setattr(c.mpn_config, f"{name}_vk", vk)
        funcs[0] = dataclasses.replace(funcs[0], verifier_key=vk)
    same_id = (ContractId.from_tx(c.genesis.body[1])
               == conf.mpn_config.mpn_contract_id)
    return c, same_id


def replayed_checksums(conf, blocks, lib=PORT) -> list:
    """`db_checksum` after each of `blocks` applied to a second dev chain
    on `conf` with the same set-up: the host's recomputation."""
    dc = DevChain(conf, lib)
    out = []
    for blk in blocks:
        dc.chain.apply_block(blk)
        out.append(dc.chain.db_checksum())
    return out


class KeyLaunches(dict):
    """The `keys` dict of `get_dev_blockchain_config` that also keeps each
    key's launch counts, read when the key is stored (the counts are set
    to 0 before the first key)."""

    def __init__(self):
        super().__init__()
        self.launches, self._last = {}, None

    def __setitem__(self, name, value):
        torch.cuda.synchronize()
        now = _cuda.counts()
        last = self._last or {k: 0 for k in now}
        self.launches[name] = {k: now[k] - last[k] for k in now}
        self._last = now
        super().__setitem__(name, value)


def devchain_phase(log4_batch: int, device):
    """The `devchain` phase: the dev chain's three keys made on the card
    by `get_dev_blockchain_config`, then two blocks (`DevChain`), each
    work proven on the card under its key and accepted by `pool.prove`
    (`MpnWork.verify`), a proof with A negated refused by the pool and,
    inside the update of a block signed again, by `apply_block` on a fork
    (IncorrectZkProof); after block 2 the balances, rewards and contract
    height of the construction, and each block's `db_checksum` equal to a
    second chain's on the VKs passed through the wire codec.  Returns
    ((launch counts, sizes) of the keys and the proofs, the dev config,
    the keys by circuit name)."""
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    keys = KeyLaunches()
    conf, key_run = counted(lambda: get_dev_blockchain_config(
        DEV_LOG4_TREE, DEV_LOG4_TOKEN_TREE, log4_batch, device=device,
        keys=keys))
    for name, k in keys.items():
        vk = k["params"].vk
        invalid = validate_vk_points(vk)
        emit({"phase": "devchain_key", "circuit": name, "nvidia_smi": card,
              "log4": [DEV_LOG4_TREE, DEV_LOG4_TOKEN_TREE, log4_batch],
              "n_constraints": k["n_constraints"],
              "d": qap.domain_size(k["n_constraints"], len(vk.ic)),
              "synthesis_s": k["synthesis_s"], "keygen_s": k["keygen_s"],
              "stage_s": k["stage_s"], "launches": keys.launches[name],
              "vk_points_valid": invalid is None})
        if invalid is not None:
            raise SystemExit(f"the dev {name} VK: {invalid}")
    emit({"phase": "devchain_keys", "nvidia_smi": card,
          "seconds": time.perf_counter() - t0,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": key_run[0]})
    require_launched("dev chain's keys", KEYGEN_KERNELS, key_run[0])

    dc = DevChain(conf)
    prover = dc.worker.get_address()
    runs, blocks, checksums, checks = [key_run], [], [], {}
    for block in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        pool = dc.prepare(block)
        prepare_s = time.perf_counter() - t1
        works, proofs = [], {}
        for wid, work in sorted(pool.works.items()):
            t2 = time.perf_counter()
            circuit, inputs = work_circuit(work, prover)
            cs = synthesize_circuit(circuit)
            t3 = time.perf_counter()
            rec = {}
            proof, run = counted(lambda: prove.create_proof(
                keys[work.data_kind]["params"], cs, device=device,
                record=rec))
            t4 = time.perf_counter()
            runs.append(run)
            proofs[wid] = ZkProof.groth16(proof)
            # `pool.prove` checks the proof by `MpnWork.verify`: one
            # pairing check on the host, timed
            verdicts = {"pool_refuses_negated_a": not pool.prove(
                wid, prover, negated_a(proofs[wid]))}
            t5 = time.perf_counter()
            verdicts["verify_and_pool_accepts"] = pool.prove(
                wid, prover, proofs[wid])
            t6 = time.perf_counter()
            works.append({"work": wid, "kind": work.data_kind,
                          "transitions": len(work.transitions),
                          "n_constraints": cs.n_constraints,
                          "synthesis_s": t3 - t2, "proof_s": t4 - t3,
                          "stage_s": rec["seconds"], "launches": run[0],
                          "verify_s": t6 - t5, **verdicts})
            checks.update({f"block{block}_{work.data_kind}_{k}": v
                           for k, v in verdicts.items()})
            del cs, circuit
        t7 = time.perf_counter()
        td, blk = dc.draft(pool, block)
        t8 = time.perf_counter()
        checks[f"block{block}_negated_a_refused_by_apply_block"] = (
            dc.refuses(dc.tampered_block(blk, negated_a(proofs[
                max(proofs)]))))
        t9 = time.perf_counter()
        dc.chain.apply_block(blk)
        t10 = time.perf_counter()
        blocks.append(blk)
        checksums.append(dc.chain.db_checksum())
        checks[f"block{block}_applied"] = dc.chain.get_height() == block + 1
        emit({"phase": "devchain_block", "nvidia_smi": card, "block": block,
              "deposits": len(pool.works[0].transitions),
              "withdraws": len(pool.works[1].transitions),
              "transfers": len(pool.works[2].transitions),
              "prepare_works_s": prepare_s, "works": works,
              "draft_block_s": t8 - t7, "refused_block_s": t9 - t8,
              "apply_block_s": t10 - t9,
              "block_hash": blk.header.hash().hex(),
              "db_checksum": checksums[-1],
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "max_memory_requested": peak_requested(),
              "host_peak_rss": host_peak_rss()})
    state, expected = dc.state(), dc.expected()
    checks.update({f"state_{k}": state[k] == v for k, v in expected.items()})
    t11 = time.perf_counter()
    conf2, same_id = wire_copy(conf)
    checks["vk_wire_round_trip_keeps_contract_id"] = same_id
    checks["db_checksum_equals_host_recomputation"] = (
        replayed_checksums(conf2, blocks) == checksums)
    proof_runs = merge_phases(*runs[1:])
    emit({"phase": "devchain", "nvidia_smi": card, "state": state,
          "expected": expected,
          "recompute_s": time.perf_counter() - t11,
          "total_s": time.perf_counter() - t0,
          "launches": merge_phases(*runs)[0], **checks})
    if not all(checks.values()):
        raise SystemExit(f"the dev chain failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    require_launched("dev chain's proofs", PROOF_KERNELS, proof_runs[0])
    return merge_phases(*runs), conf, keys


# Phase 10 (node).  The validator's wallets come from this mnemonic (the
# BIP39 test vector of 16 bytes of 0x7f), saved to a wallet file and
# opened from it.  It delegates NODE_STAKE to itself: the one staker of
# the dev genesis, the VRF elects it in every slot.  The nodes start
# NODE_LEAD_S seconds before a slot begins (both clocks skewed alike), so
# that the deposits reach the mempool before the validator's first claim
# of that slot, and its work has the whole slot (90 s on the dev config).
# The block must follow the last solution within NODE_BLOCK_WAIT_S.
NODE_MNEMONIC = ("legal winner thank year wave sausage worth useful legal"
                 " winner thank yellow")
NODE_STAKE = 10 ** 12
NODE_LEAD_S = 6
NODE_BLOCK_WAIT_S = 60.0
NODE_PORTS = (3030, 3031)  # the validator's and the peer's, in the router


def sim_node(sim, port: int, chain, wallets, bootstrap, opts):
    """A node on `chain` with `wallets` at `port` of a `Simulation`, wired
    as its `add_node` wires one (which makes a chain and wallets of its
    own)."""
    ip = f"10.0.0.{port % 250 + 1}"
    node = node_create(opts, "sim", PeerAddress(ip, port),
                       [PeerAddress(f"10.0.0.{p % 250 + 1}", p)
                        for p in bootstrap],
                       chain, wallets, sim.sender(ip))
    sim.nodes[port] = node
    return node


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def slot_skew(slot_s: int, lead_s: int, now: int) -> int:
    """The clock skew that puts the time `now` `lead_s` seconds before a
    slot of `slot_s` seconds begins."""
    return (slot_s - lead_s - now % slot_s) % slot_s


async def until(pred, timeout: float):
    """Wait for `pred()` to hold (`catch_change` of its truth); raises
    TimeoutError past `timeout`."""
    if not pred():
        await catch_change(pred, timeout=timeout)


def mark_when(marks: dict, key: str, obj, name: str, done):
    """Wrap the method `name` of the object `obj` (this object only) so
    that `marks[key]` gets the time at which a call of it first returns
    with `done()` true: the pool's last solution, the validator's block,
    the peer's sync.  (Polling from the event loop the nodes run on
    cannot tell the validator's block from the peer's sync: the peer
    applies the block before the loop turns again.)"""
    call = getattr(obj, name)

    def marked(*args, **kwargs):
        out = call(*args, **kwargs)
        if key not in marks and done():
            marks[key] = time.perf_counter()
        return out

    setattr(obj, name, marked)


def api_inputs_match(api: dict, work) -> bool:
    """A work as `GET /bincode/mpn/work` shows it against the pool's."""
    pi = work.public_inputs
    return api == {"kind": work.data_kind, "height": pi.height,
                   "state": hex(pi.state), "aux_data": hex(pi.aux_data),
                   "next_state": hex(pi.next_state), "reward": work.reward}


def card_prover(keys, device):
    """The worker's prover: the work's circuit (`work_circuit`) proven
    under the dev key of its kind on `device`; returns (ZkProof, what it
    took)."""
    def prove_work(work, prover):
        t0 = time.perf_counter()
        circuit, _ = work_circuit(work, prover)
        cs = synthesize_circuit(circuit)
        t1 = time.perf_counter()
        before, rec = _cuda.counts(), {}
        proof = prove.create_proof(keys[work.data_kind]["params"], cs,
                                   device=device, record=rec)
        torch.cuda.synchronize()
        after = _cuda.counts()
        return ZkProof.groth16(proof), {
            "n_constraints": cs.n_constraints, "synthesis_s": t1 - t0,
            "proof_s": time.perf_counter() - t1, "stage_s": rec["seconds"],
            "launches": {k: after[k] - before[k] for k in after}}
    return prove_work


async def node_flow(conf, prove_work, tmp: str, lead_s: int = NODE_LEAD_S,
                    block_wait_s: float = NODE_BLOCK_WAIT_S):
    """Phase 10's network on a copy of the dev config `conf` with
    `check_validator` on: the validator's node, its chain on a
    `DiskKvStore` in `tmp` and its wallets from a wallet file there, and a
    peer on a `RamKvStore`, both set up as `DevChain` sets up its chain
    and staked, wired through the port's `Simulation` with the simulator's
    heartbeats and automatic block generation; the validator also served
    over HTTP on 127.0.0.1.  The worker b"WORKER" registers over HTTP,
    the users' block-1 deposits go in through `BazukaClient.transact`
    before the validator's claim of the next slot, and once that claim's
    work pool is there, the worker proves each work with
    `prove_work(work, prover)` (in a thread) and posts the proofs over
    HTTP, first one with A negated.  The validator's heartbeat makes the
    block and the peer syncs it.  Returns (record, checks); a wait past
    its deadline raises."""
    t0 = time.perf_counter()
    conf = copy.deepcopy(conf)
    conf.check_validator = True
    wallet_path = os.path.join(tmp, "wallet.json")
    db_path = os.path.join(tmp, "chain.sqlite")
    wc = WalletCollection(Mnemonic(NODE_MNEMONIC))
    wc.user(0)
    wc.validator()
    wc.save(wallet_path)
    wc = WalletCollection.open(wallet_path)
    validator, user = wc.validator().tx_builder(), wc.user(0).tx_builder()
    vdc = DevChain(conf, store=DiskKvStore(db_path), validator=validator)
    pdc = DevChain(conf, validator=validator)
    for dc in (vdc, pdc):
        dc.stake(NODE_STAKE)
    prover = vdc.worker.get_address()
    checks = {"mnemonic_valid": wc.mnemonic.validate_checksum(),
              "same_chain_at_start":
              vdc.chain.db_checksum() == pdc.chain.db_checksum()}

    sim = Simulation()
    opts = get_simulator_options()
    opts.automatic_block_generation = True
    vport, pport = NODE_PORTS
    vnode = sim_node(sim, vport, vdc.chain, (validator, user), [pport], opts)
    pnode = sim_node(sim, pport, pdc.chain, (TxBuilder(b"DEV-PEER"),
                                             TxBuilder(b"DEV-PEER-user")),
                     [vport], opts)
    vctx, pctx = vnode.context, pnode.context
    http = PeerAddress("127.0.0.1", free_port())
    sender = http_sender()
    client = BazukaClient(sender, http)
    skew = slot_skew(conf.slot_duration, lead_s, int(time.time()))
    for ctx in (vctx, pctx):
        ctx.clock_skew = skew
    slot = vdc.chain.epoch_slot(vctx.network_timestamp() + lead_s)
    rec = {"check_validator": conf.check_validator,
           "slot_s": conf.slot_duration, "lead_s": lead_s,
           "clock_skew": skew, "slot": list(slot),
           "stake": NODE_STAKE, "http_port": http.port}

    await sim.start()
    server = asyncio.create_task(serve_http(vnode, http.ip, http.port))
    try:
        t1 = time.perf_counter()
        while True:
            try:
                stats = await client.stats()
                break
            except OSError:
                if time.perf_counter() - t1 > 10:
                    raise
                await asyncio.sleep(0.05)
        checks["served_over_http"] = stats["height"] == 1
        checks["worker_registered"] = await sender.json_post(
            http, "/bincode/mpn/worker", {"address": str(prover)}) == {
            "accepted": True}
        t_submit = time.perf_counter()
        deposits = vdc.mpn_txs(1)[0]
        for tx in deposits:
            await client.transact(tx)
        checks["deposits_before_the_slot"] = vdc.chain.epoch_slot(
            vctx.network_timestamp()) < slot
        checks["deposits_in_mempool"] = (
            len(list(vctx.mempool.mpn_deposits())) == len(deposits))
        reward = vdc.chain.min_validator_reward(validator.get_address())

        def slot_pool():
            claim, pool = vctx.validator_claim, vctx.mpn_work_pool
            if claim is None or pool is None or vdc.chain.epoch_slot(
                    claim.timestamp) != slot:
                return None
            return pool

        pool = await catch_change(slot_pool, timeout=lead_s + 30.0)
        t_pool = time.perf_counter()
        for dc in (vdc, pdc):
            dc.rewards.append(reward)
        checks["pool_holds_the_deposits"] = (
            [w.data_kind for _, w in sorted(pool.works.items())]
            == ["deposit", "withdraw", "update"]
            and len(pool.works[0].transitions) == len(deposits) + 1)
        api = (await sender.json_get(http, "/bincode/mpn/work",
                                     {"address": str(prover)}))["works"]
        rec["api_assigned"] = sorted(int(w) for w in api)
        checks["api_inputs_equal_pool"] = bool(api) and all(
            api_inputs_match(v, pool.works[int(w)]) for w, v in api.items())
        marks = {}
        mark_when(marks, "solved", pool, "prove",
                  lambda: len(pool.solutions) == len(pool.works))
        mark_when(marks, "block", vdc.chain, "extend",
                  lambda: vdc.chain.get_height() >= 2)
        mark_when(marks, "synced", pdc.chain, "extend",
                  lambda: pdc.chain.get_height() >= 2)
        works, accepted = [], 0
        for wid, work in sorted(pool.works.items()):
            t2 = time.perf_counter()
            proof, took = await asyncio.to_thread(prove_work, work, prover)
            t3 = time.perf_counter()
            if wid == 0:
                refused = await sender.json_post(
                    http, "/bincode/mpn/solution",
                    {"address": str(prover),
                     "proofs": {str(wid): to_hex(negated_a(proof))}})
                checks["negated_a_answered_accepted_0"] = refused == {
                    "accepted": 0}
            t4 = time.perf_counter()
            # the last post's answer may come after the block: the
            # validator's heartbeat can run between the pool's check and
            # the answer
            got = await sender.json_post(
                http, "/bincode/mpn/solution",
                {"address": str(prover), "proofs": {str(wid): to_hex(proof)}})
            accepted += got["accepted"]
            works.append({"work": wid, "kind": work.data_kind,
                          "transitions": len(work.transitions),
                          "from_api": str(wid) in api, **took,
                          "prove_s": t3 - t2, "post_s": time.perf_counter()
                          - t4, "accepted": got["accepted"]})
        checks["three_works_accepted_over_http"] = accepted == 3
        await until(lambda: "synced" in marks and "block" in marks,
                    block_wait_s)
        view = (await sender.json_get(http, "/explorer/blocks",
                                      {"since": 1, "count": 1}))["blocks"]
        tip = vdc.chain.get_tip()
        checks["explorer_renders_the_block"] = (
            len(view) == 1 and view[0]["header"]["number"] == 1
            and view[0]["header"]["hash"] == tip.hash().hex()
            and [list(tx["data"]) for tx in view[0]["body"]]
            == [["UpdateContract"]])
        rec.update({
            "deposits": len(deposits), "works": works,
            "deposits_to_pool_s": t_pool - t_submit,
            "solution_to_block_s": marks["block"] - marks["solved"],
            "block_to_sync_s": marks["synced"] - marks["block"]})
    except BaseException:
        print("node logs:", *list(LOG_LINES)[-40:], sep="\n  ",
              file=sys.stderr, flush=True)
        raise
    finally:
        await sim.stop()
        server.cancel()
        await asyncio.gather(server, return_exceptions=True)

    heights = [vdc.chain.get_height(), pdc.chain.get_height()]
    checks["both_at_height_2"] = heights == [2, 2]
    checks["disk_checksum_equals_ram_peer"] = (
        vdc.chain.db_checksum() == pdc.chain.db_checksum())
    state, expected = vdc.state(), vdc.expected(blocks=1)
    checks.update({f"state_{k}": state[k] == v for k, v in expected.items()})
    checks["peer_state_equal"] = pdc.state() == state
    checksum = vdc.chain.db_checksum()
    vdc.chain.db.close()
    again = DiskKvStore(db_path)
    checks["reopened_disk_checksum_equal"] = KvStoreChain(
        again, conf).db_checksum() == checksum
    again.close()
    rec.update({"heights": heights, "db_checksum": checksum,
                "block_hash": tip.hash().hex(), "state": state,
                "expected": expected, "total_s": time.perf_counter() - t0})
    return rec, checks


def node_phase(conf, keys, device):
    """The `node` phase (`node_flow` with the worker proving on the card
    under the `devchain` keys), its line and its checks; K1's four entries
    and K2-K5 must have run.  Returns (launch counts, sizes) of its
    proofs."""
    card = nvidia_smi_line()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        (rec, checks), run = counted(lambda: asyncio.run(
            node_flow(conf, card_prover(keys, device), tmp)))
    emit({"phase": "node", "nvidia_smi": card, **rec, "launches": run[0],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "max_memory_requested": peak_requested(), **checks})
    if not all(checks.values()):
        raise SystemExit(f"the node phase failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    require_launched("node phase's proofs", PROOF_KERNELS, run[0])
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-d", type=int, default=22,
                    help="log2 of the synthetic proof's and key's domain "
                         "(default 22; below 22 both MPN batches are cut "
                         "to 4 transfers, the mainnet one with big mode's "
                         "thresholds lowered, the Poseidon tree and batch "
                         "to 4^6 leaves and 2^16 hashes, the EdDSA batch "
                         "to 256 signatures)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    small = args.log_d < 22
    # phase 6's host halves run in a worker per cell from here on, beside
    # phases 2-5 and 7, and each satisfaction check beside its cell's key
    # (the mainnet cell's worker, the longer, starts first)
    batches = {cell: 1 if small else spec[0]
               for cell, spec in sorted(MPN_CELLS.items(), reverse=True)}
    with contextlib.ExitStack() as stack:
        waits = {cell: mpn_worker(stack.enter_context(
            multiprocessing.get_context("spawn").Pool(1)), log4_batch)
            for cell, log4_batch in batches.items()}
        return run_phases(args, device, small, batches, waits)


def run_phases(args, device, small: bool, batches: dict, waits: dict):
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    logs = _cuda.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs)})
    for src, log in logs.items():
        for line in log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"  [{src}] {line.strip()}", flush=True)

    timeline = {"build": time.perf_counter() - t0}

    def lap(name):
        timeline[name] = time.perf_counter() - t0 - sum(timeline.values())
        torch.cuda.empty_cache()

    toy_phase(device)
    lap("toy")
    proof_run = proof_phase(args.log_d, device)
    lap("proof")  # the synthetic key is gone before keygen
    keygen_run = keygen_phase(args.log_d, device)
    lap("keygen")
    # phase 7 runs before phase 6, while the worker finishes its circuit
    poseidon_run = poseidon_phase(6 if small else POSEIDON_LOG4_LEAVES,
                                  16 if small else POSEIDON_LOG2_BATCH,
                                  device)
    lap("poseidon")
    b64_runs, _ = mpn_phase("mpn_b64", *waits["mpn_b64"],
                            batches["mpn_b64"], device)
    sharded_run = b64_runs.pop("sharded")
    b64_run = merge_phases(*b64_runs.values())
    lap("mpn_b64")
    if small:
        for name, value in lower_for_small_run().items():
            print(f"lowered for the small run: {name} = {value}", flush=True)
    mpn_runs, mpn_txs = mpn_phase("mpn_b256", *waits["mpn_b256"],
                                  batches["mpn_b256"], device)
    mpn_run = merge_phases(*mpn_runs.values())
    lap("mpn")
    eddsa_run, eddsa_sharded = eddsa_phase(256 if small else EDDSA_SIGS,
                                           mpn_txs, device)
    lap("eddsa")
    devchain_run, dev_conf, dev_keys = devchain_phase(DEV_LOG4_BATCH, device)
    lap("devchain")
    node_run = node_phase(dev_conf, dev_keys, device)
    del dev_keys
    lap("node")
    sharded_run = merge_phases(sharded_run, eddsa_sharded)
    launches, sizes = merge_phases(proof_run, keygen_run, b64_run, mpn_run,
                                   poseidon_run, eddsa_run, sharded_run,
                                   devchain_run, node_run)
    rows = kernel_phase(sizes, device)
    lap("kernel")
    # the MPN key's and first proof's launches at the replayed times
    emit({"phase": "mpn_launch_weighted", **{
        run: {name: launch_weighted(rows[name], mpn_runs[run][1][name])
              for name in _cuda.REGISTRY}
        for run in ("keygen", "proof")}})
    # K1 Fr, the one kernel of phases 7-8, weighted by each one's launches
    emit({"phase": "launch_weighted", **{
        phase: {fk.K_FR.name: launch_weighted(rows[fk.K_FR.name],
                                              run[1][fk.K_FR.name])}
        for phase, run in (("poseidon", poseidon_run),
                           ("eddsa", eddsa_run))}})

    kernels = []
    for name, k in _cuda.REGISTRY.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bazuka_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[name],
            "launches_by_phase": {"proof": proof_run[0][name],
                                  "keygen": keygen_run[0][name],
                                  "mpn_b64": b64_run[0][name],
                                  "mpn": mpn_run[0][name],
                                  "poseidon": poseidon_run[0][name],
                                  "eddsa": eddsa_run[0][name],
                                  "sharded": sharded_run[0][name],
                                  "devchain": devchain_run[0][name],
                                  "node": node_run[0][name]},
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "sizes")},
        })
    emit({"phase": "timeline", "seconds": timeline,
          "total_s": sum(timeline.values())})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
