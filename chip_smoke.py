"""Smoke run of the PyTorch/CUDA port (blockmaze_tpu_torch) on one GPU, or
on four.

    python3 chip_smoke.py                # every phase; one card is enough
    python3 chip_smoke.py --mesh-only    # build, mint and deposit20 on one
                                         # card, then phases 7 and 8 and
                                         # phase 10's scaling (for a call
                                         # on four cards)

Phases, each timed; any failure raises and the script exits nonzero:
  0. build the CUDA kernels from blockmaze_tpu_torch/csrc (nvcc, sm_90a)
     and every host library of utils/kernels.HOST_LIBS (g++);
  1. every kernel against its plain torch version on the same CUDA tensors,
     bit-exact, with kernel and plain times and each kernel's bound, at the
     shapes the main path gives it: fft at mint's 2^17 and 2^16 and send's
     2^18, forward and inverse tables, and at send's 2^18 with its
     pointwise factors (coset before a forward FFT; 1/m and coset^-1 after
     an inverse one), and at deposit's 2^19 and deposit20's 2^20 forward,
     with the coset, and inverse with its factors; step_pre and step_post
     at mint's step domain (2^17 + 2^16), with and without their coset
     factors; qap_combine at 196,608 rows; mul_elementwise at 2^16 (and in
     phase 3 at the mint witness); the point kernels add, double,
     mixed_add and mixed_add_noexc at 2^18 G1 / 2^17 G2 lanes (on no
     path since fixed_base_exp took their keygen role); fixed_base_exp
     (keygen's whole window ladder and affine normalisation) on 2^18 G1
     and 2^17 G2 scalars with edge scalars (0, 1, r-1, powers of two,
     bytes of 0 and 255); decompress_g1 and decompress_g2 (a text key's
     point decompression) on 2^16 G1 and 2^14 G2 points s_i * G of seeded
     scalars with zero points and both parities, held also to the points
     themselves, and an x off its curve that must raise; the MSM kernels
     (msm_round, msm_combine,
     msm_triangle, msm_fold) at the mint MSMs' shape (2^18 G1 and 2^17 G2
     points, c = 12, 22 windows) on real blinded data cut as msm cuts its
     live stream, with runs across many lanes and combine blocks; and
     msm_round on a full stream with dead items and infinity points;
  2. MSMs at the prover's sizes against closed forms: sum_i k_i * (i*G)
     = (sum_i i*k_i mod r) * G for 2^18 G1 points and 2^14 G2 points;
  3. the mint circuit end to end (run_circuit: constraints and witness
     from circuits/instances.py, keygen with seeded toxic waste, Prover on
     cuda:0, three proofs, each verified by the port's verifier, the two
     with equal (r, s) equal, each constraint matrix's terms, longest row
     and warp rows, live items and lanes per MSM); then the witness's way
     to the card (widen_parity: wire_widen bit-exact against its plain
     version and ints_to_limbs on the witness's own words and wide rows
     and on a block of wide rows, the Prover's _limbs + _upload equal to
     mul_elementwise(to_tensor(ints_to_limbs)) by R^2, and the blocking
     copies of the pinned words, the pageable words and the pageable
     64-byte rows timed); mul_elementwise
     on the mint witness by the R^2 row (its one launch on the main path;
     timed beside the host to_mont_host it replaced) and qap_matvec on the
     mint key's own CSR and witness (bit-exact, timed), one more QAP
     witness map under torch.cuda.set_sync_debug_mode("error") (it must
     not wait for the device), msm_round on the proof's own five live
     streams (timed, and bit-exact against its plain version on the sparse
     A and the dense H stream), the MSMs' time over a sweep of lane
     counts, and a profiled proof;
  4. send (basic domain, 2^18), redeem (step, 2^17 + 2^16), deposit
     (basic, 2^19) and deposit20 (deposit at Merkle depth 20: basic, 2^20,
     window c = 13) end to end, each as mint in run_circuit; on deposit
     and deposit20 widen_parity as on mint; on each basic
     domain the QAP witness map on the card against its plain path on the
     card, on the circuit's own CSR and witness; on deposit20 the four MSM
     kernels at c = 13, W = 20 against their plain versions on the proof's
     own A and H streams;
  5. the zktx service and the node lifecycle with real proofs, at Merkle
     depth 8 and then 20 (scripts/lifecycle.py on the port, through its
     driver's run_lifecycle): ZkTx on
     cuda:0 over phases 3-4's keys, warm(), mint 100 -> send 40 -> deposit
     -> redeem 25 between two Nodes, every proof verified at pool admission
     and at block import, the balances, a double deposit rejected and a
     wallet reloaded; synthesis, prove and verify seconds per transaction;
  6. Prover.prove_batch on mint (step domain) and deposit (basic, 2^19):
     four distinct witnesses, each batch proof verified and equal to prove
     at the same (r, s), and batches of B = 1, 2, 4, 8 (mint) and 1, 4
     (deposit) timed beside B x the steady single proof;
  7. the mesh (parallel/): MESH_SHARDS = 4 shards, on cuda:0..3 when four
     cards are visible, else all on cuda:0 (an explicit device list; the
     placement and torch.cuda.device_count() are printed). With two or
     more cards, kernels on cuda:1 tensors while cuda:0 is current
     (mul_elementwise and fft against their plain versions, an MSM
     against the same MSM on cuda:0 and its closed form). The batched
     fft (one launch over a shard's block of sub-FFTs) bit-exact against
     fft_plain at the sharded shapes: mint's 2^17 = 256 x 512 and 2^16 =
     256 x 256 (forward and inverse tables) and deposit20's 2^20 = 1024 x
     1024 (forward with the coset, inverse with 1/m and coset^-1 in
     standard form), each shard's column batch (step 2's twiddles as its
     post factor) and row batch, timed with its bound. The sharded FFT,
     inverse, coset FFT and inverse coset FFT at basic 2^18 and 2^20 and
     at mint's step domain, each equal to the single-card tntt result and
     timed beside it. sharded_msm over 1, 2 and 4 shards on phase 2's
     2^18 G1 points against the closed form, with and without a blind:
     ms, Mpoints/s and efficiency (scripts/scaling.py's counterpart). A
     Prover on the mesh over mint's and deposit20's keys from phases 3-4:
     two proofs at (r, s) = (1, 2), each equal to the single-card proof at
     (1, 2), and one at random (r, s), all verified, their launches
     against MESH_PATH, their phases beside the single-card steady
     proof's; one mint prove_batch of B = 2 on the mesh, each proof
     verified. A `mesh summary:` line holds phase 7's numbers;
  8. the process mesh (parallel.distributed, parallel.mesh.ProcessMesh):
     the largest power of two at most min(PROCESS_RANKS = 4, cards)
     processes (every padded size splits evenly over them), one a card,
     over nccl when two or more cards are visible, else 2 processes on
     cuda:0 over gloo
     (the placement, the backend and torch.cuda.device_count() are
     printed). Each rank is this script started again with an internal
     flag (RANK_FLAG), joins the group through distributed.initialize and
     runs on distributed.global_mesh(): sharded_msm over the ranks on
     phase 2's 2^18 G1 points against the closed form, with and without a
     blind (ms, Mpoints/s and t1 / (k tk) against the single-card MSM of
     the same call, which rank 0 times alone); the sharded FFT, inverse,
     coset FFT and inverse coset FFT (std) at basic 2^20 and at mint's
     step domain against tntt on the rank's card, timed beside it; a
     Prover(mesh=global_mesh()) over mint's and deposit20's cached keys
     (no keygen and no synthesis in a rank: the parent writes the
     witnesses and its single-card proofs to a temporary directory): two
     proofs at (1, 2) equal to the single-card proof, one at random (r,
     s) equal on every rank and verified, the launches per rank against
     process_mesh_path(k), the phases and torch.cuda.max_memory_allocated
     after the Prover's init beside the single-card Prover's; then the
     mint Prover's prove_batch of the parent's BATCH_RS witnesses
     (scripts.batch.batch_instance), each proof equal to the parent's
     single-card proof at its (r, s) and verified, the launches against
     process_mesh_path(k). A rank that exits nonzero or overruns
     RANK_TIMEOUT fails the script. A `process mesh summary:` line holds
     phase 8's numbers;
  9. the reference's text keys (TEXT_KEY_CIRCUITS: mint and deposit at
     Merkle depth 8, the two extremes of key size): phases 3-4's key
     written once with the port's io.write_proving_key into
     blockmaze_tpu_torch/_keys/text/ (timed apart), loaded back through
     keys.load_or_build(..., device=cuda:0) into a fresh cache directory
     (the host tokenizer csrc/keyparse.cpp, one decompress_g1 and one
     decompress_g2 launch, one mul_elementwise for the coefficients:
     KEYLOAD_LAUNCHES exactly, counted around the load alone), the npz it
     writes held to KEY_SHA256, a proof at (1, 2) from the loaded key
     equal to the keygen key's and verified, each decompression kernel
     held bit-exact against its plain version on the card on the very
     arrays the load gave it (these shapes, deposit's last, are the
     kernels line's); the load's phases (tokenize,
     upload, each kernel's CUDA-event ms beside its bound at these shapes,
     coefficients, npz write, total) and the Python reader's seconds per
     point on a sample of the file's first points (READER_SAMPLE), in a
     `text key summary:` line per circuit. It runs after phase 6;
 10. the port's drivers (blockmaze_tpu_torch/scripts), after phase 8:
     first msm_round, msm_combine, msm_triangle and msm_fold against their
     plain versions at msmbench's shapes (MSMBENCH_RUNS, c = 13,
     pippenger.MAX_LANES lanes) on its own inputs, blinded as it runs
     them (the kernels line keeps these times under "shapes"); then each
     driver started as `python -m blockmaze_tpu_torch.scripts.<name>`
     from the repository's root with _build/ and _keys/ warm: msmbench
     --phases at 2^19 G1 and 2^18 G2 (their closed forms), warmstart mint (a fresh
     process), e2e mint, batch --circuit mint --batch 8 and prewarm
     --circuits mint (every proof verified; phase 5 is lifecycle's
     run_lifecycle at depths 8 and 20), the bench (bench.py's
     counterpart) twice: over all four circuits on the seeded keys, and
     over mint and deposit with --key-dir set to a temporary directory
     laid out as bench.py's reference_harness/prfKey/ (links to phase
     9's text keys and the seeded vks: the text-key load on a miss), each
     circuit's first proof and REPS timed proofs verified and their
     launches held to PROVE_PATH by domain kind, and
     scaling on a process mesh of 2 ranks (one a card over nccl when two
     or more cards are visible, else both on cuda:0 over gloo; with four
     cards also of 4) against its closed form. Each must exit 0 within
     DRIVER_TIMEOUT, print its OK line (DRIVER_OK) and end with a JSON
     line whose launches hold its path's kernels; a `drivers summary:`
     line keeps their numbers. With --mesh-only, scaling alone.
Each circuit's launch counts are reset just before its keygen and read
just after it, and reset again just before its three proofs and read just
after them; phase 5 reads them around each transaction and phase 6 around
each batch, and phase 9 around each text key's load; each driver of phase
10 resets them before its measured work and reports them in its JSON line:
each path must launch each of its kernels. The keygen path
(KEYGEN_PATH): one fixed_base_exp per query (six) and one
mul_elementwise (the coefficients' Montgomery form), never a batched
point kernel (add, double, mixed adds). Each keygen's summary splits its
seconds by phase and prints a sha256 digest of every DevicePK array and
of the vk file; their digest over all must equal KEY_SHA256 (the keys of
SEED that keygen made before fixed_base_exp, with the batched point
kernels), loaded keys included. The prove path by
domain kind (PROVE_PATH): never the batched point kernels (add, double,
mixed adds), which the bucket reduction replaced there, nor the
single-stage butterfly, which fft replaced; on a step domain at most 28
fft launches per proof (two passes for each of 14 FFTs) and at most 12 of
qap_matvec, step_pre, step_post and qap_combine; on a basic domain at most
14 fft launches (7 FFTs of two passes, their factors inside), one
qap_matvec, one qap_combine, no step_pre or step_post; on both at most
one wire_widen (the witness's words to limbs) and one mul_elementwise
(their Montgomery form). add, double,
mixed_add, mixed_add_noexc and butterfly are on neither path; phase 1
holds them against their plain versions. The mesh prove path by domain
kind (MESH_PATH, per proof of a 4-shard Prover): the single-card path's
kernels, each fft launch a shard's batch of column or row FFTs (at most
112 on the step domain, 56 on a basic one), qap_matvec once a shard, and
add, the K3 kernel, folding each MSM's partials (at most 5 x 3 a proof);
never butterfly, double, the mixed adds or fixed_base_exp. The process
mesh's path per rank (process_mesh_path(k), per proof): at most two fft
launches a transform, one qap_matvec, 5 (k - 1) add, never the same
kernels; the MSM kernels over the ranks together (a rank whose block of
every query is padding launches none). A kernel's launches in the
kernel table are its sum over every path of every circuit, phases 7's
and 8's (every rank's) included. Each
circuit prints a summary line (sizes, MSM shapes, keygen, Prover and
proof times). The second-to-last line is the kernel table as JSON (not
printed with --mesh-only); the last line is the result JSON. With no GPU
it exits nonzero before printing either.

Bounds: the least time the card could take for a kernel's work on the
inputs it was timed on, the larger of (bytes in + bytes out) / 3.35 TB/s
and IMAD count / 16.7 T/s. One Montgomery product of 256-bit operands (8 x
32-bit CIOS) is 264 IMAD: 128 32x32->64 products at 2 IMAD each, and 8 for
the reduction factors. 16.7 T/s = 132 SMs x 64 IMAD per clock x 1.98 GHz,
half the float32 FMA rate behind the 67 TFLOP/s of the card's data sheet.
Products are counted per point operation on the path each input takes
(G1/G2 Fq products: add 16/43, double 7/16, mixed add 11/29; msm_round one
mixed add per live item; fixed_base_exp what s * G needs from the
window table: a mixed add for each nonzero digit of a scalar after its
first (the blind's two adds left out), then for each nonzero scalar the
affine normalisation at the cost of one batch inversion (Montgomery's
trick) over the query: 3 products per point (G2: 3 Fq2 products, 9 Fq)
and 4 (G2: 11) for x Z^-2 and y Z^-3, plus one Fermat inversion per query
of 253 squarings and 109 multiplies (G2: of the norm, 4 Fq products
around it)),
per butterfly for fft (k * 2^(k-1)) plus one per element and
factor, per term for qap_matvec, and per element and step for step_pre,
step_post and qap_combine, per point for decompress_g1 and
decompress_g2 what the kernel's chains take (decompress_products: G1
364 Fq products per nonzero point, G2 1,710; G2's Tonelli-Shanks loop,
under 4% and dependent on the point, is left out).
"""

from __future__ import annotations

import functools
import json
import os
import pickle
import random
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

try:    # the seeded keys' seed and cache, shared with the port's drivers
    from blockmaze_tpu_torch.scripts._common import KEY_CACHE, SEED
except ModuleNotFoundError:     # not in a checkout: require_gpu says so
    KEY_CACHE = SEED = None
# key_digests(...)["all"] of each circuit's keys for SEED, as keygen made
# them with the batched point kernels (add, mixed_add, mixed_add_noexc)
# and the host affine conversion before fixed_base_exp replaced both:
# keygen must reproduce them bit for bit
KEY_SHA256 = {
    "mint": "82953cebaf04d3bcaee51f76b3b2e1b1d64c6f92347b261ff541780883a4cca4",
    "send": "79e6c64a4b371e096c411953ec9dfbc5d9b6850dce727cabbcc9c5741bd16a81",
    "redeem":
        "55e532753cd6b1758cd97d7e90938e7efb58ab68ab485a18469c21521a8fde32",
    "deposit":
        "6ed4b29c20b2cf4e66986f9a28b8b7571ecd37352bd25af8df09eb8ee6a3ccec",
    "deposit20":
        "9432c8f5689f2c9761eb96065c86e6088cd1612426854878941a0b90c8d2f8a2",
}
MEM_RATE = 3.35e12     # bytes/s
IMAD_RATE = 132 * 64 * 1.98e9
IMAD_PER_PRODUCT = 264
PRODUCTS = {"g1": {"add": 16, "dbl": 7, "madd": 11, "affine": 3 + 4,
                   "inv": 362},
            "g2": {"add": 43, "dbl": 16, "madd": 29, "affine": 9 + 11,
                   "inv": 362 + 4}}
ORDER = ["fft", "butterfly", "mul_elementwise", "qap_matvec", "step_pre",
         "step_post", "qap_combine", "add", "double", "msm_round",
         "msm_combine", "msm_triangle", "msm_fold", "mixed_add",
         "mixed_add_noexc", "fixed_base_exp", "decompress_g1",
         "decompress_g2", "wire_widen"]
# keygen: one fixed_base_exp per query (A, H, L, the vk's inputs, B in G2
# and G1) and the coefficients' Montgomery form in one mul_elementwise;
# the batched point kernels it ran before stay off this path too
KEYGEN_PATH = ["fixed_base_exp", "mul_elementwise"]
KEYGEN_LAUNCHES = {"fixed_base_exp": 6, "mul_elementwise": 1}
# loading a text key (keys.load_or_build on a miss): one decompress_g1 for
# every G1 point of the key, one decompress_g2 for B's G2 points and one
# mul_elementwise for the coefficients, nothing else
KEYLOAD_LAUNCHES = {"decompress_g1": 1, "decompress_g2": 1,
                    "mul_elementwise": 1}
DECOMPRESS = ["decompress_g1", "decompress_g2"]
POINT_KERNELS = ["add", "double", "mixed_add", "mixed_add_noexc"]
QAP_KERNELS = ["qap_matvec", "step_pre", "step_post", "qap_combine"]
MSM_KERNELS = ["msm_round", "msm_combine", "msm_triangle", "msm_fold"]
# the batched point kernels (the bucket reduction replaced them on the prove
# path, fixed_base_exp on the keygen path), keygen's own kernel and the
# single-stage butterfly (fft replaced it)
OFF_PROVE_PATH = POINT_KERNELS + ["fixed_base_exp", "butterfly",
                                  *DECOMPRESS]
# The prove path by domain kind: the kernels each proof launches, those it
# must not launch, and the most launches per proof of each group of
# kernels. A step domain's 7 FFTs each run a big and a small part (two
# passes each); a basic domain's 7 FFTs two passes each, their pointwise
# factors inside; the witness's words take their limbs in one wire_widen
# and their Montgomery form in one mul_elementwise.
PROVE_PATH = {
    "step": {"launch": ["wire_widen", "fft", "mul_elementwise",
                        *QAP_KERNELS, *MSM_KERNELS],
             "never": OFF_PROVE_PATH,
             "at_most": [(["wire_widen"], 1), (["fft"], 28),
                         (["mul_elementwise"], 1), (QAP_KERNELS, 12)]},
    "basic": {"launch": ["wire_widen", "fft", "mul_elementwise",
                         "qap_matvec", "qap_combine", *MSM_KERNELS],
              "never": OFF_PROVE_PATH + ["step_pre", "step_post"],
              "at_most": [(["wire_widen"], 1), (["fft"], 14),
                          (["mul_elementwise"], 1), (["qap_matvec"], 1),
                          (["qap_combine"], 1)]},
}
# phase 4's circuits, in order (mint is phase 3's); deposit20 is the
# deposit at Merkle depth 20
CIRCUITS = ["send", "redeem", "deposit", "deposit20"]
# Phase 7: a mesh of MESH_SHARDS shards (cuda:0..3 with four cards, else
# four shards on cuda:0), and the circuits it proves beside their
# single-card proofs.
MESH_SHARDS = 4
MESH_CIRCUITS = ["mint", "deposit20"]
# The mesh prove path by domain kind, per proof: each shard runs two fft
# launches a transform (its batch of column FFTs, its batch of row FFTs;
# a step domain's big and small part each), one qap_matvec (its block of
# rows) and the MSM kernels of its block of every MSM; the lead device
# the witness's limbs and Montgomery form, the step domain's stages and
# qap_combine; each MSM folds its shards' partials with n - 1 point adds.
MESH_NEVER = ["butterfly", "double", "mixed_add", "mixed_add_noexc",
              "fixed_base_exp", *DECOMPRESS]
MESH_PATH = {
    "step": {"launch": ["wire_widen", "fft", "mul_elementwise",
                        *QAP_KERNELS, *MSM_KERNELS, "add"],
             "never": MESH_NEVER,
             "at_most": [(["wire_widen"], 1), (["fft"], 28 * MESH_SHARDS),
                         (["mul_elementwise"], 1),
                         (["qap_matvec"], MESH_SHARDS),
                         (["step_pre", "step_post", "qap_combine"], 8),
                         (["add"], 5 * (MESH_SHARDS - 1))]},
    "basic": {"launch": ["wire_widen", "fft", "mul_elementwise",
                         "qap_matvec", "qap_combine", *MSM_KERNELS, "add"],
              "never": MESH_NEVER + ["step_pre", "step_post"],
              "at_most": [(["wire_widen"], 1), (["fft"], 14 * MESH_SHARDS),
                          (["mul_elementwise"], 1),
                          (["qap_matvec"], MESH_SHARDS),
                          (["qap_combine"], 1),
                          (["add"], 5 * (MESH_SHARDS - 1))]},
}
# Phase 8: at most PROCESS_RANKS processes, one a card (two on one card
# when only one is visible), each started as `chip_smoke.py RANK_FLAG
# <work dir> <device>` and given RANK_TIMEOUT seconds.
PROCESS_RANKS = 4
RANK_FLAG = "--process-mesh-rank"
RANK_TIMEOUT = 480
# and each rank's prove_batch: BATCH_CIRCUIT's witnesses
# scripts.batch.batch_instance(i) at (r, s) = BATCH_RS[i]
BATCH_CIRCUIT = "mint"
BATCH_RS = [(1, 51), (2, 52)]
# Phase 10: the line each driver prints when its run held, and the most
# seconds a driver's run may take
DRIVER_OK = {"msmbench": "MSMBENCH OK", "warmstart": "WARMSTART OK",
             "e2e": "E2E OK", "batch": "BATCH OK", "prewarm": "PREWARM DONE",
             "scaling": "SCALING OK", "bench": "BENCH OK"}
DRIVER_TIMEOUT = 300
# msmbench's runs, (curve, log2 points) at window MSMBENCH_WINDOW, whose
# MSM kernels phase 10 holds against their plain versions on its inputs
MSMBENCH_RUNS = [("g1", 19), ("g2", 18)]
MSMBENCH_WINDOW = 13


def process_mesh_path(ranks: int) -> dict:
    """The process mesh's prove path by domain kind, per rank and proof:
    one wire_widen and one mul_elementwise (each rank's witness on its
    lead device), two fft launches a transform (the rank's column batch,
    its row batch), one qap_matvec (its block of rows), the step domain's
    stages and qap_combine on every rank, each MSM's partials folded with
    ranks - 1 point adds; never the kernels off MESH_PATH. The MSM kernels
    are not required of a rank: one whose block of every MSM is padding
    (the last of four on mint, whose queries fill 3/4 of 2^18 rows)
    launches none; phase 8 requires them of the ranks together."""
    return {
        "step": {"launch": ["wire_widen", "fft", "mul_elementwise",
                            *QAP_KERNELS, "add"],
                 "never": MESH_NEVER,
                 "at_most": [(["wire_widen"], 1), (["fft"], 28),
                             (["mul_elementwise"], 1),
                             (["qap_matvec"], 1),
                             (["step_pre", "step_post", "qap_combine"], 8),
                             (["add"], 5 * (ranks - 1))]},
        "basic": {"launch": ["wire_widen", "fft", "mul_elementwise",
                             "qap_matvec", "qap_combine", "add"],
                  "never": MESH_NEVER + ["step_pre", "step_post"],
                  "at_most": [(["wire_widen"], 1), (["fft"], 14),
                              (["mul_elementwise"], 1),
                              (["qap_matvec"], 1), (["qap_combine"], 1),
                              (["add"], 5 * (ranks - 1))]}}


# Phase 9: the depth-8 circuits at the two extremes of key size, whose
# phase-3/4 keys are written as the reference's text keys and loaded back,
# and the Python reader's sample: its first G1 points of A and G2 points
# of B
TEXT_KEY_CIRCUITS = ["mint", "deposit"]
READER_SAMPLE = {"g1": 20000, "g2": 2000}
# rows a plain decompression call takes when phase 9 holds the kernels
# against it at a key's shapes (its int64 temporaries stay under ~1 GB)
PLAIN_CHECK_ROWS = 1 << 18
# run_circuit's results of TEXT_KEY_CIRCUITS for phase 9: name -> (vk,
# primary, aux, proof at (1, 2))
TEXT_RUNS = {}
# run_circuit's single-card results of MESH_CIRCUITS, for phases 7 and 8:
# name -> (prover, vk, primary, aux, proof at (1, 2), proof timings,
# the Prover's device memory: {"allocated_mb", "peak_mb"})
RUNS = {}
ROW = 64               # bytes of one Fr element (16 int32 limbs)


def log(*a):
    print(*a, flush=True)


def require_gpu():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this script only runs on a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "blockmaze_tpu_torch", "csrc")):
        sys.exit("chip_smoke: blockmaze_tpu_torch/csrc not found next to "
                 "this script; run it from a checkout of the repository")
    sys.path.insert(0, here)


def timed(fn, reps: int = 5) -> float:
    """Milliseconds per call of fn on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(products: int, nbytes: int):
    """(bound_ms, bound_by) for `products` Montgomery products and `nbytes`
    bytes moved."""
    ops_ms = products * IMAD_PER_PRODUCT / IMAD_RATE * 1e3
    mem_ms = nbytes / MEM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def main():
    mesh_only = sys.argv[1:] == ["--mesh-only"]
    if sys.argv[1:] and not mesh_only:
        sys.exit(f"chip_smoke: unknown arguments {sys.argv[1:]} (the one "
                 f"option is --mesh-only)")
    require_gpu()
    from blockmaze_tpu_torch.utils import kernels as kn

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            and smi.stdout.strip() else "nvidia-smi: unavailable")
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0))
    rng = np.random.default_rng(SEED)
    # no PyTorch call computes a BN254 Montgomery product or a curve
    # operation, so no kernel has a library yardstick
    report = {name: {"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "library_ms": None}
              for name, k in kn.K.items()}
    t_all = time.perf_counter()

    # ---- phase 0: build --------------------------------------------------
    t0 = time.perf_counter()
    lib = kn.build(verbose=True)
    kn.kernel_lib()
    t1 = time.perf_counter()
    host = [kn.host_lib(src)._name for src in kn.HOST_LIBS]
    log(f"phase 0 build: {time.perf_counter() - t0:.1f}s ({lib}; the host "
        f"libraries {time.perf_counter() - t1:.1f}s, {host})")

    if mesh_only:
        # the mesh's inputs alone: the single-card runs it is held against
        path_counts = []
        for circuit in MESH_CIRCUITS:
            t0 = time.perf_counter()
            path_counts += run_circuit(circuit, dev)[3]
            log(f"{circuit} on one card: {time.perf_counter() - t0:.1f}s")
    else:
        path_counts = single_card_phases(dev, rng, report)

    # ---- phase 7: the mesh -----------------------------------------------
    t0 = time.perf_counter()
    counts7, summary7 = phase7(dev, rng, report)
    path_counts += counts7
    log(f"phase 7 mesh: {time.perf_counter() - t0:.1f}s")

    # ---- phase 8: the process mesh ---------------------------------------
    t0 = time.perf_counter()
    path_counts += phase8(summary7)
    log(f"phase 8 process mesh: {time.perf_counter() - t0:.1f}s")

    # ---- phase 10: the port's drivers -------------------------------------
    t0 = time.perf_counter()
    path_counts += phase10(mesh_only, dev, report)
    log(f"phase 10 drivers: {time.perf_counter() - t0:.1f}s")
    for name in kn.K:
        report[name]["launches"] = sum(c.get(name, 0) for c in path_counts)
    log(f"total: {time.perf_counter() - t_all:.1f}s")
    log(card)      # again, next to the results (the build's log is long)
    if not mesh_only:
        log(json.dumps({"kernels": [report[k] for k in ORDER]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def single_card_phases(dev, rng, report):
    """Phases 1-6; returns their paths' launch counts."""
    # ---- phase 1: parity -------------------------------------------------
    t0 = time.perf_counter()
    phase1(dev, rng, report)
    log(f"phase 1 parity: {time.perf_counter() - t0:.1f}s")

    # ---- phase 2: MSM at the prover's sizes ------------------------------
    t0 = time.perf_counter()
    phase2(dev)
    log(f"phase 2 msm closed forms: {time.perf_counter() - t0:.1f}s")

    # ---- phase 3: mint end to end ----------------------------------------
    t0 = time.perf_counter()
    path_counts = phase3(dev, report)
    log(f"phase 3 mint: {time.perf_counter() - t0:.1f}s")

    # ---- phase 4: send, redeem, deposit, deposit20 end to end ------------
    for circuit in CIRCUITS:
        t0 = time.perf_counter()
        path_counts += phase4(circuit, dev, report)
        log(f"phase 4 {circuit}: {time.perf_counter() - t0:.1f}s")

    # ---- phase 5: the zktx service and node lifecycle, real proofs -------
    for depth in (8, 20):
        t0 = time.perf_counter()
        path_counts += phase5(depth, dev)
        log(f"phase 5 lifecycle depth {depth}: "
            f"{time.perf_counter() - t0:.1f}s")

    # ---- phase 6: prove_batch ----------------------------------------
    for name in BATCHES:
        t0 = time.perf_counter()
        path_counts += phase6(name, dev)
        log(f"phase 6 prove_batch {name}: {time.perf_counter() - t0:.1f}s")

    # ---- phase 9: the reference's text keys ------------------------------
    for name in TEXT_KEY_CIRCUITS:
        t0 = time.perf_counter()
        path_counts += phase9(name, dev, report)
        log(f"phase 9 text key {name}: {time.perf_counter() - t0:.1f}s")
    return path_counts


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def rand_field(rng, shape, dev):
    """Canonical random limbs: the top limb stays below the moduli's
    (0x3064), so every value is < p for both Fq and Fr."""
    a = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.int64)
    a[..., 15] = rng.integers(0, 0x3064, size=shape)
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def rand_coord(curve, rng, n, dev):
    return rand_field(rng, (n,) if curve == "g1" else (n, 2), dev)


def with_edge_lanes(P, Q):
    """Make lanes 0-1 infinite P, 2-3 infinite Q, 4-5 both, 6-7 Q = P and
    8-9 Q = -P (same X and Z, negated Y)."""
    from blockmaze_tpu_torch.fields import tfield as tf
    P = [t.clone() for t in P]
    Q = [t.clone() for t in Q]
    P[2][0:2] = 0
    Q[2][2:4] = 0
    P[2][4:6] = 0
    Q[2][4:6] = 0
    for k in range(3):
        Q[k][6:10] = P[k][6:10]
    Q[1][8:10] = tf.neg(tf.FQ, P[1][8:10]).to(torch.int32)
    return tuple(P), tuple(Q)


def same(a, b) -> bool:
    return all(torch.equal(x.to(torch.int64), y.to(torch.int64))
               for x, y in zip(a, b))


def max_abs_err(a, b) -> int:
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               for x, y in zip(a, b))


def finite(Z):
    """Per point: Z != 0 (G1 (n, 16), G2 (n, 2, 16))."""
    return Z.reshape(Z.shape[0], -1).ne(0).any(1)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Phase 1: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def record_kernel(report, key, res, products, moved, primary=False,
                  tag=None):
    """Keep the first shape's times and bound (or this one's, if primary);
    every shape's error; a tagged shape's times and bound under
    "shapes"[tag] beside them."""
    err, ms, pms = res
    b_ms, b_by = bound(products, moved)
    log(f"  {'':<16} bound {b_ms:.5f} ms ({b_by}: {products} products, "
        f"{moved} bytes)")
    r = report[key]
    r["max_abs_err"] = max(err, r.get("max_abs_err", 0))
    times = dict(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
    if tag is not None:
        r.setdefault("shapes", {})[tag] = times
    elif primary or "ms" not in r:
        r.update(times)


def check_kernel(name, shape, kern, plain, reps=5):
    """Kernel against plain on the same inputs: (max_abs_err, kernel ms,
    plain ms); raises unless bit-exact."""
    got = kern()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    pms = start.elapsed_time(end)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max_abs_err(got, want)
    ok = same(got, want)
    ms = timed(kern, reps)
    log(f"  {name:<16} {shape:<40} bit-exact={ok} max_abs_err={err} "
        f"kernel {ms:.4f} ms  plain {pms:.3f} ms")
    if not ok:
        raise AssertionError(f"{name}: kernel != plain at {shape}")
    return err, ms, pms


def phase1(dev, rng, report):
    from blockmaze_tpu_torch.curves import pcurve as pc
    from blockmaze_tpu_torch.curves import tcurve as tc
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.msm import pippenger as pp
    from blockmaze_tpu_torch.ntt import pntt

    check = check_kernel
    record = functools.partial(record_kernel, report)

    # warm the plain path's torch kernels so its first timing is not a
    # measure of CUDA module loading
    w = rand_field(rng, (4,), dev)
    pntt.mul_elementwise_plain(w, w)
    tf.sub(tf.FQ, w, w)
    mint_d, mint = fft_parity(dev, rng, check, record)
    step_parity(mint_d, mint, dev, rng, check, record)
    # K2: pointwise Fr product, 2^16 elements; K1: one stage of 2^16
    # butterflies (span 2^15, the second-to-last stage of a 2^17 FFT)
    a = rand_field(rng, (1 << 16,), dev)
    b = rand_field(rng, (1 << 16,), dev)
    record("mul_elementwise", check(
        "mul_elementwise", "Fr (2^16, 16)",
        lambda: pntt.mul_elementwise(a, b),
        lambda: pntt.mul_elementwise_plain(a, b), reps=20),
        a.shape[0], 3 * nbytes(a))
    m, span = 1 << 17, 1 << 15
    x = rand_field(rng, (m,), dev)
    tw = rand_field(rng, (span,), dev)
    record("butterfly", check(
        "butterfly", "Fr stage m=2^17 span=2^15",
        lambda: pntt.butterfly(x, tw, span),
        lambda: pntt.butterfly_plain(x, tw, span), reps=20),
        m // 2, 2 * nbytes(x) + nbytes(tw))

    # K3, K4, K7, K8 (on no path: fixed_base_exp took their keygen role)
    # at 2^18 G1 and 2^17 G2 lanes, the shapes of the keygen chunk they
    # ran, with edge lanes
    for curve, n in (("g1", 1 << 18), ("g2", 1 << 17)):
        F = tc.ops(curve)
        pr = PRODUCTS[curve]
        P = tuple(rand_coord(curve, rng, n, dev) for _ in range(3))
        Q = tuple(rand_coord(curve, rng, n, dev) for _ in range(3))
        P, Q = with_edge_lanes(P, Q)
        qinf = torch.from_numpy(rng.random(n) < 0.05).to(dev)
        qinf[0:4] = torch.tensor([True, False, True, False], device=dev)
        Qa = [Q[0].clone(), Q[1].clone()]
        for k in range(2):   # lanes 6-9: affine Q = P's X and +-Y with Z = 1
            Qa[k][6:10] = P[k][6:10]
        Pm = [t.clone() for t in P]
        Pm[2][6:10] = F.one_like(Pm[2][6:10]).to(torch.int32)
        Qa[1][8:10] = tf.neg(tf.FQ, P[1][8:10]).to(torch.int32)
        shape = f"{curve} n={n}"
        both = finite(P[2]) & finite(Q[2])
        equal = both & torch.stack([(p == q).reshape(n, -1).all(1)
                                    for p, q in zip(P, Q)]).all(0)
        # an equal pair stops after 8 products and doubles instead
        add_products = int(both.sum()) * pr["add"] + int(equal.sum()) * (
            8 + pr["dbl"] - pr["add"])
        pt_bytes = nbytes(*P)
        record("add", check("add", shape, lambda: pc.add(curve, P, Q),
                            lambda: tc.point_add(F, P, Q)),
               add_products, 3 * pt_bytes)
        record("double", check("double", shape, lambda: pc.double(curve, P),
                               lambda: tc.point_double(F, P)),
               n * pr["dbl"], 2 * pt_bytes)
        live = int((finite(Pm[2]) & ~qinf).sum())
        madd_bytes = 2 * pt_bytes + nbytes(Qa[0], Qa[1], qinf)
        record("mixed_add", check(
            "mixed_add", shape,
            lambda: pc.mixed_add(curve, Pm, Qa[0], Qa[1], qinf),
            lambda: tc.point_mixed_add(F, Pm, Qa[0], Qa[1], qinf)),
            live * pr["madd"], madd_bytes)
        record("mixed_add_noexc", check(
            "mixed_add_noexc", shape,
            lambda: pc.mixed_add_noexc(curve, Pm, Qa[0], Qa[1], qinf),
            lambda: tc.point_mixed_add_noexc(F, Pm, Qa[0], Qa[1], qinf)),
            int((~qinf).sum()) * pr["madd"], madd_bytes)

    fixed_base_parity(dev, rng, check, record)
    decompress_parity(dev, rng, check, record)

    # the MSM kernels at the mint MSMs' shape: n = nA = nH = nL in G1,
    # n = nB in G2
    for curve, n in (("g1", 1 << 18), ("g2", 1 << 17)):
        msm_parity(curve, n, dev, rng, check, record)


def edge_scalars(n, rng, dev):
    """(n, 16) int32 standard-form scalars: 0, 1, r-1, r-2, powers of two,
    scalars whose bytes are 0 or 255 in some windows, then random ones
    below r."""
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.fields.constants import R_MOD
    edge = [0, 1, R_MOD - 1, R_MOD - 2, 2, 1 << 8, 1 << 100, 1 << 252, 255,
            0xff << 240, (1 << 248) - 1, int("ff00" * 16, 16) % R_MOD,
            int("00ff" * 16, 16) % R_MOD, 255 << 8, 0]
    s = rand_field(rng, (n,), dev)
    s[:len(edge)] = tf.to_tensor(tf.ints_to_limbs(edge), dev)
    return s


def fixed_base_parity(dev, rng, check, record,
                      sizes=(("g1", 1 << 18), ("g2", 1 << 17))):
    """fixed_base_exp (one launch: the whole blinded window ladder and the
    affine normalisation) against its plain version at keygen's shapes:
    2^18 G1 and 2^17 G2 scalars (mint's A/H/L and B queries are 151k-197k
    and 43k), edge scalars first. Products counted on these scalars as
    s * G needs them: a mixed add for each nonzero digit after a scalar's
    first, the batch-inversion normalisation of each nonzero scalar's
    point and one inversion."""
    from blockmaze_tpu_torch.curves import host_curve as HC
    from blockmaze_tpu_torch.groth16 import generator as gen
    from blockmaze_tpu_torch.msm import pippenger as pp
    for curve, n in sizes:
        base = HC.g1_generator() if curve == "g1" else HC.g2_generator()
        table = gen.window_table(curve, base, dev)
        blind = pp.make_blind(curve, dev)[1]
        sc = edge_scalars(n, rng, dev)
        res = check(
            "fixed_base_exp", f"{curve} n={n}",
            lambda: gen.fixed_base_exp(curve, table, sc, blind),
            lambda: gen.fixed_base_exp_plain(curve, table, sc, blind),
            reps=3)
        pr = PRODUCTS[curve]
        nz = (pp.digits(sc, gen.WINDOW_C) != 0).sum(0)
        adds = int((nz - 1).clamp(min=0).sum())
        products = (adds * pr["madd"] + int((nz > 0).sum()) * pr["affine"]
                    + pr["inv"])
        out_bytes = 2 * nbytes(table.x[0, 0]) * n + n
        moved = nbytes(sc) + nbytes(table.packed, table.flags) + out_bytes
        record("fixed_base_exp", res, products, moved)


def std_limbs(spec, t):
    """Montgomery limbs (a tensor) in standard form, int32, by tfield's
    plain ops in chunks of 2^18 rows."""
    from blockmaze_tpu_torch.fields import tfield as tf
    return torch.cat([tf.from_mont(spec, c).to(torch.int32)
                      for c in t.split(1 << 18)])


def off_curve_x(curve):
    """The smallest x (G2: (x, 1)) whose y^2 is no square: a point of that
    x is on no curve."""
    from blockmaze_tpu_torch.curves import host_curve as HC
    from blockmaze_tpu_torch.fields import host as hf
    from blockmaze_tpu_torch.fields.constants import Q_MOD
    if curve == "g1":
        return next(x for x in range(1, 100)
                    if hf.fq_sqrt((x ** 3 + 3) % Q_MOD) is None)
    return next((x, 1) for x in range(1, 100) if hf.fq2_sqrt(hf.fq2_add(
        hf.fq2_mul(hf.fq2_sqr((x, 1)), (x, 1)), HC.g2_b_coeff())) is None)


def decompress_products(curve, zero) -> int:
    """The Fq products decompress_{curve} runs on points with these zero
    flags, the one count behind its bounds: for each nonzero point the
    chain of its root (dc.G1_CHAIN, dc.G2_CHAIN; for G2 also x = a w0,
    b = x w0 and b's S - 1 squarings) and the products around it
    (dc.G1_AROUND, dc.G2_AROUND). G2's Tonelli-Shanks loop, at most
    S - 1 rounds of a few products whose count depends on the point
    (under 4% of its work), is left out, so the bound stays below the
    work."""
    from blockmaze_tpu_torch.curves import decompress as dc
    if curve == "g1":
        per = sum(dc.G1_CHAIN) + dc.G1_AROUND
    else:
        per = (dc.G2_CHAIN[0] * dc.G2_SQR + dc.G2_CHAIN[1] * dc.G2_MUL
               + 2 * dc.G2_MUL + (dc.TS_S - 1) * dc.G2_SQR + dc.G2_AROUND)
    return int((zero == 0).sum()) * per


def decompress_bytes(xs) -> int:
    """Bytes decompress_g1/g2 must move: x, lsb and zero in; x, y, inf and
    bad out."""
    return 3 * nbytes(xs) + 4 * xs.shape[0]


def decompress_parity(dev, rng, check, record,
                      sizes=(("g1", 1 << 16), ("g2", 1 << 14))):
    """decompress_g1 and decompress_g2 (one thread a point: y from x and
    the parity bit, the key's affine Montgomery limbs out) against their
    plain versions on 2^16 G1 and 2^14 G2 points s_i * G of seeded scalars
    (edge scalars first, 0 among them, and 16 more zeros: zero points),
    compressed as a text key holds them (x in standard form, the parity of
    y or y.c0, the zero flag; both parities occur); the result must also
    be the points themselves. Products and bytes: decompress_products and
    decompress_bytes. Then one x off its curve among 256 points must raise
    ValueError naming its index."""
    from blockmaze_tpu_torch.curves import decompress as dc
    from blockmaze_tpu_torch.curves import host_curve as HC
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.groth16 import generator as gen
    from blockmaze_tpu_torch.msm import pippenger as pp
    for curve, n in sizes:
        base = HC.g1_generator() if curve == "g1" else HC.g2_generator()
        sc = edge_scalars(n, rng, dev)
        sc[16:32] = 0
        pts = gen.fixed_base_exp(curve, gen.window_table(curve, base, dev),
                                 sc, pp.make_blind(curve, dev)[1])
        x, y, inf = pts
        xs = std_limbs(tf.FQ, x)
        ystd = std_limbs(tf.FQ, y if curve == "g1" else y[:, 0])
        lsb = torch.where(inf, 1, ystd[:, 0] & 1).to(torch.uint8)
        xs[inf] = 0
        zero = inf.to(torch.uint8)
        parities = set(lsb[~inf].unique().tolist())
        if parities != {0, 1} or int(inf.sum()) < 17:
            raise AssertionError(f"decompress_{curve}: inputs lack a "
                                 f"parity or zero points")
        name = f"decompress_{curve}"
        res = check(name, f"{curve} n={n}, {int(inf.sum())} zero",
                    lambda: dc.decompress(curve, xs, lsb, zero),
                    lambda: dc.PLAIN[curve](xs, lsb, zero)[:3])
        if not same(dc.decompress(curve, xs, lsb, zero), pts):
            raise AssertionError(f"{name}: not the points themselves")
        log(f"  {name:<16} equal to the points s_i * G: True")
        record(name, res, decompress_products(curve, zero),
               decompress_bytes(xs))
        # an x off its curve at index 5 of 256 points raises
        bad = xs[:256].clone()
        bad[5] = tf.to_tensor(tf.ints_to_limbs(
            [off_curve_x(curve)] if curve == "g1" else
            list(off_curve_x(curve))).reshape(bad[5].shape), dev)
        try:
            dc.decompress(curve, bad, lsb[:256], zero[:256])
        except ValueError as e:
            if "points[5]" not in str(e):
                raise
            log(f"  {name:<16} off-curve x raised: {e}")
        else:
            raise AssertionError(f"{name}: an x off the curve passed")


def fft_parity(dev, rng, check, record):
    """fft against its plain version (gather, then one butterfly_plain per
    stage) with the tables the prover moves to the card: mint's step domain
    (its 2^17 and 2^16 parts) and send's basic 2^18, forward and inverse;
    then at send's 2^18 with the factors a basic domain's coset FFT (coset
    before) and inverse coset FFT (1/m and coset^-1 after) fuse into it;
    then at deposit's 2^19 and deposit20's 2^20 (a second pass of 9 and 10
    stages at stride 2^10), forward, forward with the coset and inverse
    with 1/m and coset^-1 in standard form (the prover's last FFT).
    Returns mint's domain and tables."""
    from blockmaze_tpu_torch.ntt import domain as TD
    from blockmaze_tpu_torch.ntt import pntt, tntt
    mint_d = TD.get_evaluation_domain((1 << 17) + (1 << 16))
    mint = tntt.tables_to({**tntt.qap_tables(mint_d),
                           **tntt.std_tables(mint_d)}, dev)
    t0 = time.perf_counter()
    send = tntt.tables_to(tntt.qap_tables(TD.get_evaluation_domain(1 << 18)),
                          dev)
    log(f"  host QAP tables 2^18 basic (built once per domain; the Prover "
        f"takes them from this cache): {time.perf_counter() - t0:.1f}s")
    cases = [(f"{p}{d} 2^{k}", mint[p + "perm"], mint[p + d], {})
             for p, k in (("big_", 17), ("small_", 16))
             for d in ("fwd", "inv")]
    cases += [("basic fwd 2^18", send["perm"], send["fwd"], {}),
              ("basic inv 2^18", send["perm"], send["inv"], {}),
              ("basic fwd 2^18 pre=coset", send["perm"], send["fwd"],
               {"pre": send["coset"]}),
              ("basic inv 2^18 scale=1/m post=coset^-1", send["perm"],
               send["inv"], {"scale": send["minv"],
                             "post": send["coset_inv"]})]
    for k in (19, 20):
        d = TD.get_evaluation_domain(1 << k)
        t0 = time.perf_counter()
        T = tntt.tables_to({**tntt.qap_tables(d), **tntt.std_tables(d)}, dev)
        log(f"  host QAP tables 2^{k} basic: {time.perf_counter() - t0:.1f}s")
        cases += [(f"basic fwd 2^{k}", T["perm"], T["fwd"], {}),
                  (f"basic fwd 2^{k} pre=coset", T["perm"], T["fwd"],
                   {"pre": T["coset"]}),
                  (f"basic inv 2^{k} scale=1/m post=coset^-1 std", T["perm"],
                   T["inv"], {"scale": T["minv"],
                              "post": T["coset_inv_std"]})]
    for name, perm, tw, factors in cases:
        m = perm.shape[0]
        k = m.bit_length() - 1
        a = rand_field(rng, (m,), dev)
        products = k * m // 2 + m * len(factors)
        record("fft", check(
            "fft", f"Fr {name} ({len(pntt.fft_passes(k))} passes)",
            lambda: pntt.fft(a, perm, tw, **factors),
            lambda: pntt.fft_plain(a, perm, tw, **factors), reps=20),
            products,
            2 * nbytes(a) + nbytes(perm, tw, *factors.values()))
    return mint_d, mint


def step_parity(d, T, dev, rng, check, record):
    """step_pre, step_post and qap_combine against their plain versions at
    mint's step domain (m = 2^17 + 2^16, compr = 2) with the prover's
    tables: step_pre with the coset (coset FFT, the main path's) and
    without (plain FFT); step_post without a factor (inverse FFT), with
    coset^-1 and with coset^-1 in standard form (the prover's last step);
    qap_combine over m rows with 1/Z."""
    from blockmaze_tpu_torch.ntt import pntt
    m, big, small = d.m, d.big_m, d.small_m
    a = rand_field(rng, (m,), dev)
    for coset in (T["coset"], None):
        record("step_pre", check(
            "step_pre", f"mint m={m} compr={big // small} "
            f"coset={coset is not None}",
            lambda: pntt.step_pre(a, T["omega_pows"], small, coset),
            lambda: pntt.step_pre_plain(a, T["omega_pows"], small, coset),
            reps=20),
            big + (m if coset is not None else 0),
            (2 * m + big + (m if coset is not None else 0)) * ROW)
    u0 = rand_field(rng, (big,), dev)
    u1 = rand_field(rng, (small,), dev)
    tabs = (T["omega_pows"], T["omega_inv_pows"], T["big_minv"],
            T["small_minv"], T["half"])
    for label, post in (("none", None), ("coset^-1", T["coset_inv"]),
                        ("coset^-1 std", T["coset_inv_std"])):
        record("step_post", check(
            "step_post", f"mint m={m} compr={big // small} post={label}",
            lambda: pntt.step_post(u0, u1, *tabs, post),
            lambda: pntt.step_post_plain(u0, u1, *tabs, post), reps=20),
            2 * big + 3 * small + (m if post is not None else 0),
            (big + small + (big - small) + small + 3 + m
             + (m if post is not None else 0)) * ROW)
    x, y, z = (rand_field(rng, (m,), dev) for _ in range(3))
    record("qap_combine", check(
        "qap_combine", f"mint m={m}",
        lambda: pntt.qap_combine(x, y, z, T["zinv"]),
        lambda: pntt.qap_combine_plain(x, y, z, T["zinv"]), reps=20),
        2 * m, 5 * m * ROW)


def accumulate_bytes(curve, keys, pids, live, pts, T, drop):
    """Bytes msm_round must move: the stream, each distinct point of its
    live items once, the T lanes' outputs and the bucket arrays."""
    pt_row = 3 * nbytes(pts[0][0])
    used = int(torch.unique(pids[:live]).numel())
    return (nbytes(keys, pids) + used * (2 * nbytes(pts[0][0]) + 1)
            + 2 * T * pt_row + 3 * T * 4 + drop * (pt_row + 4))


def msm_parity(curve, n, dev, rng, check, record):
    """msm_round, msm_combine, msm_triangle and msm_fold against their
    plain versions on real data at the window the MSM takes for n points
    (c = 12, 22 windows at the mint's sizes): n points i*G, half of them
    with scalar 0 or 1 (so window 0's bucket 1 is one run across many
    lanes and several combine blocks), half random, accumulated blinded
    (the exception-free mixed add needs real points and a blind), on the
    live stream cut as msm cuts it (stream_parity). Then msm_round alone
    on the JAX package's full stream (dead items, a tenth of the points at
    infinity) of 2^14 points at 4,096 lanes, unblinded, and msm_fold on
    windows that take each branch of its add."""
    from blockmaze_tpu_torch.msm import pippenger as pp
    c = pp.default_window(n)
    pts = curve_points(curve, n, dev)
    sc = torch.from_numpy(rng.integers(0, 1 << 16, (n, 16),
                                       dtype=np.int64)).to(dev)
    sc[:, 15] &= 0x2fff
    sc[: n // 2] = 0
    sc[: n // 2, 0] = torch.from_numpy(rng.integers(0, 2, n // 2)).to(dev)
    stream = pp.live_stream(pts, sc, c)
    _, blind = pp.make_blind(curve, dev)
    win = stream_parity(curve, pts, stream, blind, c, f"{curve} n={n}",
                        check, record)
    drop = stream[2]
    m = 1 << 14
    fpts = tuple(t[n - m:].clone() for t in pts)
    fpts[2][::10] = True
    fk, fp, _ = pp.stream_keys(fpts, sc[n - m:], c)
    fT = 4096
    fL = -(-fk.shape[0] // fT)
    fk, fp = pp.pad_stream(fk, fp, drop, fT, fL)
    check("msm_round", f"{curve} full stream n={m} T={fT} L={fL}",
          lambda: flat_acc(pp.accumulate(curve, fk, fp, fpts, None, fT, fL,
                                         drop)),
          lambda: flat_acc(pp.accumulate_plain(curve, fk, fp, fpts, None,
                                               fT, fL, drop)), reps=3)
    # the add's branches: windows (top first) inf, P, P, A, inf with c = 0
    # take p = inf, P = Q (doubling), the general add and q = inf
    P1 = tuple(t[1:2] for t in win)
    A = tuple(t[2:3] for t in win)
    inf = tuple(torch.zeros_like(t) for t in P1)
    edge = tuple(torch.cat(parts) for parts in zip(inf, A, P1, P1, inf))
    check("msm_fold", f"{curve} W=5 c=0 (inf/double/general branches)",
          lambda: pp.fold(curve, 0, edge),
          lambda: pp.fold_plain(curve, 0, edge), reps=1)


def stream_parity(curve, pts, stream, blind, c, label, check, record):
    """The MSM's four kernels, each against its plain version on the
    previous one's output: msm_round on the live stream (keys, point ids,
    DROP) cut into pippenger.MAX_LANES lanes at most, msm_combine on its
    boundary partials, msm_triangle on the buckets, msm_fold on the
    window sums, at window c; each timed with its bound. Returns the
    window sums."""
    from blockmaze_tpu_torch.msm import pippenger as pp
    pr = PRODUCTS[curve]
    W, nb = pp.n_windows(c), 1 << c
    keys, pids, drop = stream
    live = keys.shape[0]
    T, L = pp.lane_cut(live, pp.MAX_LANES)
    keys, pids = pp.pad_stream(keys, pids, drop, T, L)
    dev = keys.device
    pt_row = 3 * nbytes(pts[0][0])
    record("msm_round", check(
        "msm_round", f"{label} c={c} live={live} T={T} L={L}",
        lambda: flat_acc(pp.accumulate(curve, keys, pids, pts, blind, T, L,
                                       drop)),
        lambda: flat_acc(pp.accumulate_plain(curve, keys, pids, pts, blind,
                                             T, L, drop)), reps=3),
        live * pr["madd"],
        accumulate_bytes(curve, keys, pids, live, pts, T, drop))
    acc, meta, head, bkt0, cnt0 = pp.accumulate(curve, keys, pids, pts,
                                                blind, T, L, drop)
    cnt0 = cnt0.to(torch.int64)
    bkeys, bpts, bcn = pp.boundary_partials(curve, acc, meta, head)
    runs = torch.unique_consecutive(bkeys[bkeys < drop], return_counts=True)[1]
    items = 2 * pp.combine_threads(curve)
    log(f"  {label} reduction input: T={T} L={L}, {bkeys.shape[0]} "
        f"partials, longest run {int(runs.max())} partials "
        f"({int(runs.max()) / items:.1f} combine blocks of {items})")
    bk = [tuple(b.clone() for b in bkt0) for _ in range(2)]
    ck = [cnt0.clone() for _ in range(2)]

    def run_kernel():
        pp.combine(curve, bkeys, bpts, bcn, bk[0], ck[0], drop)
        return bk[0] + (ck[0],)

    def run_plain():
        pp.combine_plain(curve, bkeys, bpts, bcn, bk[1], ck[1], drop,
                         pp.combine_threads(curve))
        return bk[1] + (ck[1],)

    # the adds the data needs: one per finite partial past the first of
    # each run
    live_p = bkeys < drop
    rid = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.int64,
                                              device=dev),
                                  (bkeys[1:] != bkeys[:-1]).long()]), 0)
    fin = torch.zeros(int(rid.max()) + 1, dtype=torch.int64, device=dev)
    fin.index_add_(0, rid[live_p], finite(bpts[2])[live_p].long())
    merges = int((fin - 1).clamp(min=0).sum())
    record("msm_combine", check(
        "msm_combine", f"{label} c={c} 2T={bkeys.shape[0]} blocks of {items}",
        run_kernel, run_plain, reps=5),
        merges * pr["add"],
        nbytes(bkeys, bcn, *bpts) + int(runs.numel()) * (pt_row + 8))

    bkt = bk[0]
    nonempty = int(finite(bkt[2]).reshape(W, nb)[:, 1:].sum())
    chunk, threads, blocks = pp.triangle_sizes(nb)
    record("msm_triangle", check(
        "msm_triangle", f"{label} W={W} c={c} chunk={chunk} "
        f"{threads}x{blocks}/window",
        lambda: pp.triangle(curve, bkt, W, nb),
        lambda: pp.triangle_plain(curve, bkt, W, nb, chunk), reps=5),
        2 * nonempty * pr["add"], nbytes(*bkt) + W * pt_row)

    win = pp.triangle(curve, bkt, W, nb)
    record("msm_fold", check(
        "msm_fold", f"{label} W={W} c={c}",
        lambda: pp.fold(curve, c, win),
        lambda: pp.fold_plain(curve, c, win), reps=5),
        (W - 1) * (c * pr["dbl"] + pr["add"]), W * pt_row + pt_row)
    return win


def flat_acc(res):
    acc, meta, head, bkt, cnt = res
    return tuple(acc) + (meta,) + tuple(head) + tuple(bkt) + (cnt,)


@functools.lru_cache(maxsize=None)
def curve_points(curve, n, dev):
    """Affine points i*G for i = 1..n as device tensors (X, Y, inf), built
    by a host chain of additions; built once per (curve, n)."""
    from blockmaze_tpu_torch.curves import host_curve as HC
    from blockmaze_tpu_torch.curves import tcurve as tc
    from blockmaze_tpu_torch.fields import tfield as tf
    if curve == "g1":
        G, add, conv = HC.g1_generator(), HC.g1_add, tc.g1_affine_to_device
    else:
        G, add, conv = HC.g2_generator(), HC.g2_add, tc.g2_affine_to_device
    pts = [G]
    for _ in range(n - 1):
        pts.append(add(pts[-1], G))
    x, y, inf = conv(pts)
    return (tf.to_tensor(x, dev), tf.to_tensor(y, dev),
            torch.from_numpy(inf).to(dev))


# ---------------------------------------------------------------------------
# Phase 2: MSM at real sizes against the closed form
# ---------------------------------------------------------------------------

def phase2(dev):
    from blockmaze_tpu_torch.curves import host_curve as HC
    from blockmaze_tpu_torch.curves import tcurve as tc
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.fields.constants import R_MOD
    from blockmaze_tpu_torch.msm import pippenger as pp

    py = random.Random(SEED)
    for curve, logn in (("g1", 18), ("g2", 14)):
        n = 1 << logn
        t0 = time.perf_counter()
        pts = curve_points(curve, n, dev)
        ks = [py.randrange(R_MOD) for _ in range(n)]
        sc = tf.to_tensor(tf.ints_to_limbs(ks), dev)
        t_in = time.perf_counter() - t0
        c = pp.default_window(n)
        R, blind = pp.make_blind(curve, dev)
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pp.msm(curve, pts, sc, c, pp.MAX_LANES, blind=blind)
            torch.cuda.synchronize()
            t_msm = time.perf_counter() - t0
            log(f"  msm {curve} n=2^{logn} c={c} lanes={pp.MAX_LANES} run "
                f"{rep}: "
                f"{t_msm * 1e3:.1f} ms")
        to_host = tc.g1_jacobian_to_host if curve == "g1" \
            else tc.g2_jacobian_to_host
        got = pp.unblind_msm(curve, to_host(tuple(v[None] for v in res[:3]))[0],
                             res[3].cpu().numpy(), R, c)
        k = sum((i + 1) * ki for i, ki in enumerate(ks)) % R_MOD
        want = (HC.g1_mul(HC.g1_generator(), k) if curve == "g1"
                else HC.g2_mul(HC.g2_generator(), k))
        log(f"  msm {curve} n=2^{logn} equals (sum i*k_i)*G: {got == want} "
            f"(inputs built in {t_in:.1f}s)")
        if got != want:
            raise AssertionError(f"msm {curve} 2^{logn} != closed form")


# ---------------------------------------------------------------------------
# Phases 3 and 4: each circuit end to end
# ---------------------------------------------------------------------------

def check_launches(path, counts, expected, forbidden=()):
    log(f"  {path} launches: {json.dumps(counts)}")
    missing = [k for k in expected if counts.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"{path}: kernels never launched: {missing}")
    stray = [k for k in forbidden if counts.get(k, 0) != 0]
    if stray:
        raise RuntimeError(f"{path}: kernels launched that the path no "
                           f"longer uses: {stray}")


def check_prove_counts(kind, counts, proofs, path=None):
    """The prove path's launches over `proofs` proofs against
    PROVE_PATH[kind] (kind: the domain's, "step" or "basic"), or against
    path[kind] (MESH_PATH)."""
    want = (path or PROVE_PATH)[kind]
    check_launches(f"{kind}-domain {'mesh ' if path else ''}prove path "
                   f"({proofs} proofs)", counts, want["launch"],
                   want["never"])
    log("  per proof: " + json.dumps(
        {k: v / proofs for k, v in counts.items() if v}))
    for group, most in want["at_most"]:
        n = sum(counts[k] for k in group)
        if n > most * proofs:
            raise RuntimeError(f"{kind}-domain prove path: {n / proofs} "
                               f"launches of {group} per proof, more than "
                               f"{most}")


def prover_memory(dev, before: int) -> dict:
    """A Prover's device memory, MB: what its init left allocated beyond
    `before`, and the peak since the last reset_peak_memory_stats."""
    return {"allocated_mb": round((torch.cuda.memory_allocated(dev) - before)
                                  / 2**20, 1),
            "peak_mb": round(torch.cuda.max_memory_allocated(dev) / 2**20,
                             1)}


def domain_kind(domain) -> str:
    from blockmaze_tpu_torch.ntt.domain import BasicDomain
    return "basic" if isinstance(domain, BasicDomain) else "step"


def run_circuit(name, dev):
    """Circuit `name` (circuits/instances.py) end to end on the card:
    constraints and witness, keygen with seeded toxic waste (cached in
    blockmaze_tpu_torch/_keys/<name>_s<SEED>; its launches when it runs),
    Prover on cuda:0, three proofs ((r, s) = (1, 2) twice, then random)
    with their phases, the prove path's launches against its domain kind's,
    each proof verified, the two with equal (r, s) equal; then the key's
    matrices and the last proof's MSM streams described. Prints a summary
    line for PERF.md. Returns (prover, primary, aux, [keygen launches,
    prove launches])."""
    from blockmaze_tpu_torch.circuits import instances
    from blockmaze_tpu_torch.groth16 import generator, verifier
    from blockmaze_tpu_torch.groth16.prover import Prover
    from blockmaze_tpu_torch.msm import pippenger as pp
    from blockmaze_tpu_torch.utils import kernels as kn

    t0 = time.perf_counter()
    pb = instances.protoboard(name)
    if not pb.is_satisfied():
        raise AssertionError(f"{name} witness does not satisfy its "
                             f"constraints")
    summary = {"circuit": name, "variables": pb.num_variables,
               "constraints": len(pb.constraints),
               "synthesis_s": round(time.perf_counter() - t0, 1)}
    log(f"  {name} circuit: {pb.num_variables} variables, "
        f"{len(pb.constraints)} constraints, satisfied "
        f"({summary['synthesis_s']}s)")
    cache = KEY_CACHE
    path_counts = []
    dpk, vk, generated, kg = keygen(pb, name, cache, dev)
    summary.update(kg)
    if generated:
        path_counts.append(kg["keygen_launches"])
        check_keygen_counts(kg["keygen_launches"])
    else:
        log(f"  keys loaded from {cache} ({summary['key_load_s']}s); "
            f"keygen path not run")
    primary, aux = pb.primary_input(), pb.auxiliary_input()
    del pb
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    prover = Prover(dpk, dev)
    torch.cuda.synchronize()
    mem = prover_memory(dev, before)
    kind = domain_kind(prover.domain)
    summary.update(prover_init_s=round(time.perf_counter() - t0, 1),
                   m=prover.domain.m, domain=kind, nA=prover.nA,
                   nB=prover.nB, nH=prover.nH, nL=prover.nL,
                   c=prover.window, W=pp.n_windows(prover.window),
                   lanes=prover.lanes)
    log(f"  Prover(cuda:0): {summary['prover_init_s']}s (domain m="
        f"{prover.domain.m} {kind}, nA={prover.nA}, nB={prover.nB}, "
        f"nH={prover.nH}, nL={prover.nL}, c={prover.window}, "
        f"W={summary['W']}, lanes={prover.lanes})")
    proofs, times = [], []
    kn.reset_counts()
    for i, (r, s) in enumerate(((1, 2), (1, 2), (None, None))):
        t0 = time.perf_counter()
        proof = prover.prove(primary, aux, r=r, s=s)
        dt = time.perf_counter() - t0
        phases = {k: round(v, 4) for k, v in prover.timings.items()}
        times.append({"s": round(dt, 4), **phases})
        log(f"  prove {i} ({'first' if i == 0 else 'steady'}): {dt:.3f}s "
            f"phases {json.dumps(phases)}")
        proofs.append(proof)
    torch.cuda.synchronize()
    path_counts.append(kn.counts())
    check_prove_counts(kind, path_counts[-1], len(proofs))
    summary["proofs"] = times
    for i, proof in enumerate(proofs):
        t0 = time.perf_counter()
        ok = verifier.verify(vk, primary, proof)
        log(f"  verify proof {i}: {ok} ({time.perf_counter() - t0:.1f}s)")
        if not ok:
            raise AssertionError(f"{name} proof {i} rejected by the verifier")
    if (proofs[0].a, proofs[0].b, proofs[0].c) != \
            (proofs[1].a, proofs[1].b, proofs[1].c):
        raise AssertionError(f"{name}: two proofs with equal (r, s) differ")
    log("  proofs 0 and 1 (equal r, s; fresh blinds) equal: True")
    if name in MESH_CIRCUITS:
        RUNS[name] = (prover, vk, primary, aux, proofs[0], times[1], mem)
    if name in TEXT_KEY_CIRCUITS:
        TEXT_RUNS[name] = (vk, primary, aux, proofs[0])
    matrix_stats(name, prover)
    summary["live"] = digit_stats(prover)
    log(f"  circuit summary: {json.dumps(summary)}")
    return prover, primary, aux, path_counts


def keygen(pb, name, cache, dev):
    """generate_cached for circuit `name` into `cache` with the launch
    counts reset before it; fixed_base_exp's calls timed on the card (CUDA
    events around each). Returns (dpk, vk, generated, summary fields):
    keygen_s (or key_load_s), its phases, fixed_base_exp's ms per query,
    the launches and the key's digests, whose digest over all must be
    KEY_SHA256[name]."""
    from blockmaze_tpu_torch.groth16 import generator
    from blockmaze_tpu_torch.utils import kernels as kn

    exps = []
    wrapped_exp = generator.fixed_base_exp

    def timed_exp(curve, table, scalars, blind):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = wrapped_exp(curve, table, scalars, blind)
        end.record()
        torch.cuda.synchronize()
        exps.append((curve, scalars.shape[0], start.elapsed_time(end)))
        return out

    timings = {}
    generator.fixed_base_exp = timed_exp
    kn.reset_counts()
    t0 = time.perf_counter()
    try:
        dpk, vk, generated = generator.generate_cached(
            pb, name, SEED, cache, dev, timings=timings)
        torch.cuda.synchronize()
    finally:
        generator.fixed_base_exp = wrapped_exp
    dt = round(time.perf_counter() - t0, 3)
    out = {}
    if generated:
        out["keygen_s"] = dt
        out["keygen_phases"] = {k: round(v, 3) for k, v in timings.items()}
        out["fixed_base_exp_ms"] = [(c, n, round(ms, 3))
                                    for c, n, ms in exps]
        out["keygen_launches"] = {k: v for k, v in kn.counts().items()
                                  if v}
        log(f"  keygen (seed {SEED}) + npz/vk cache write and load: {dt}s "
            f"phases {json.dumps(out['keygen_phases'])}")
        log(f"  fixed_base_exp (curve, n, ms): "
            f"{json.dumps(out['fixed_base_exp_ms'])}")
        log(f"  keygen launches: {json.dumps(out['keygen_launches'])}")
    else:
        out["key_load_s"] = dt
    out["key_sha256"] = key_digests(cache, name)
    log(f"  key digests: {json.dumps(out['key_sha256'])}")
    if out["key_sha256"]["all"] != KEY_SHA256[name]:
        raise AssertionError(f"{name} keys differ from KEY_SHA256: digest "
                             f"{out['key_sha256']['all']}")
    log(f"  {name} keys equal to KEY_SHA256's")
    return dpk, vk, generated, out


def check_keygen_counts(counts):
    """The keygen path: exactly KEYGEN_LAUNCHES, no batched point kernel."""
    check_launches("keygen path", counts, KEYGEN_PATH, POINT_KERNELS)
    for k, want in KEYGEN_LAUNCHES.items():
        if counts.get(k, 0) != want:
            raise RuntimeError(f"keygen path: {counts.get(k, 0)} launches "
                               f"of {k}, not {want}")


def key_digests(cache, name) -> dict:
    """_common.key_digests of the circuit's npz DevicePK and vk file in
    `cache`."""
    from blockmaze_tpu_torch.groth16 import generator
    from blockmaze_tpu_torch.scripts import _common as cm
    return cm.key_digests(*generator.cache_paths(name, SEED, cache))


def write_text_key(npz, txt, dev):
    """The reference's text key (io.write_proving_key, the port's copy of
    the JAX package's writer) of the cached DevicePK at npz: its points
    and coefficients in standard form (tfield's plain ops on the card),
    then as host ints."""
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.groth16 import keys
    from blockmaze_tpu_torch.serialization import libsnark_io as io
    dpk = keys.load_device_pk(npz)

    def ints(a, spec=tf.FQ):
        return tf.limbs_to_ints(
            std_limbs(spec, tf.to_tensor(a, dev)).cpu().numpy())

    def g1(pts):
        x, y, inf = pts
        return list(zip(ints(x), ints(y), (int(f) for f in inf)))

    def g2(pts):
        x, y, inf = pts
        return list(zip(zip(ints(x[:, 0]), ints(x[:, 1])),
                        zip(ints(y[:, 0]), ints(y[:, 1])),
                        (int(f) for f in inf)))

    cons = [([], [], []) for _ in range(dpk.num_constraints)]
    for k, sel in enumerate("abc"):
        coeffs = ints(getattr(dpk, f"{sel}_coeff"), tf.FR)
        for r, v, c in zip(getattr(dpk, f"{sel}_row").tolist(),
                           getattr(dpk, f"{sel}_var").tolist(), coeffs):
            cons[r][k].append((v, c))
    pk = io.ProvingKey(
        alpha_g1=dpk.alpha_g1, beta_g1=dpk.beta_g1, beta_g2=dpk.beta_g2,
        delta_g1=dpk.delta_g1, delta_g2=dpk.delta_g2, A_query=g1(dpk.A),
        B_domain=dpk.num_variables + 1, B_indices=dpk.B_idx.tolist(),
        B_g2=g2(dpk.B2), B_g1=g1(dpk.B1), H_query=g1(dpk.H),
        L_query=g1(dpk.L), cs=io.ConstraintSystem(
            dpk.primary_input_size, dpk.aux_input_size, cons))
    os.makedirs(os.path.dirname(txt), exist_ok=True)
    keys.replace_atomically(txt, lambda tmp: io.write_proving_key(tmp, pk))


def reader_sample(txt) -> dict:
    """The Python reader's (libsnark_io.read_g1 / read_g2) seconds per point
    on the first READER_SAMPLE points of A (G1) and of B (G2): a sample,
    not a full load."""
    from blockmaze_tpu_torch.serialization import libsnark_io as io
    ts = io.TokenStream(txt)
    try:
        for read in (io.read_g1, io.read_g1, io.read_g2, io.read_g1,
                     io.read_g2):
            read(ts)
        n_a = ts.next_int()
        k1 = min(n_a, READER_SAMPLE["g1"])
        t0 = time.perf_counter()
        for _ in range(k1):
            io.read_g1(ts)
        g1_s = (time.perf_counter() - t0) / k1
        for _ in range(3 * (n_a - k1)):
            ts.next()
        ts.next_int()                                   # B's domain
        for _ in range(ts.next_int()):                  # B's indices
            ts.next()
        k2 = min(ts.next_int(), READER_SAMPLE["g2"])
        g2_s = 0.0
        for _ in range(k2):
            t0 = time.perf_counter()
            io.read_g2(ts)
            g2_s += time.perf_counter() - t0
            for _ in range(3):                          # its G1 half
                ts.next()
    finally:
        ts.close()
    return {"g1_points": k1, "g1_us_per_point": round(g1_s * 1e6, 1),
            "g2_points": k2, "g2_us_per_point": round(g2_s / k2 * 1e6, 1)}


def phase9(name, dev, report):
    """Circuit `name`'s phase-3/4 key as the reference's text key (written
    once into blockmaze_tpu_torch/_keys/text/, timed apart), loaded back
    through keys.load_or_build(..., device=cuda:0) into a fresh cache
    directory with the launch counts reset just before and read just
    after (KEYLOAD_LAUNCHES exactly); the npz it writes must have
    KEY_SHA256[name]'s digests, and a Prover on the loaded key must give
    at (1, 2) the keygen key's proof, which verifies. Each decompression
    kernel is then held against its plain version on the card on the very
    arrays the load handed it (bit-exact, PLAIN_CHECK_ROWS rows a plain
    call; the load's own result equal to a second launch), and this shape
    becomes the kernel's on the kernels line; so is mul_elementwise on the
    key's coefficients (phase 1's shape stays its line's). Prints the load's
    phases (tokenize, upload, the two kernels' CUDA-event ms with their
    bounds at these shapes, coefficients, npz write, total), the Python
    reader's sample and a `text key summary:` line. Returns the load
    path's launch counts."""
    import shutil
    from blockmaze_tpu_torch.curves import decompress as dc
    from blockmaze_tpu_torch.groth16 import generator, keys, verifier
    from blockmaze_tpu_torch.groth16.prover import Prover
    from blockmaze_tpu_torch.ntt import pntt
    from blockmaze_tpu_torch.utils import kernels as kn
    vk, primary, aux, want = TEXT_RUNS[name]
    npz, vk_path = generator.cache_paths(name, SEED, KEY_CACHE)
    txt = os.path.join(KEY_CACHE, "text", f"{name}_s{SEED}.txt")
    summary = {"circuit": name}
    if not os.path.exists(txt):
        t0 = time.perf_counter()
        write_text_key(npz, txt, dev)
        summary["write_text_s"] = round(time.perf_counter() - t0, 2)
        log(f"  text key written: {txt} ({summary['write_text_s']}s)")
    summary["file_mb"] = round(os.path.getsize(txt) / 2**20, 1)

    raw, events, timings = dc.decompress_raw, [], {}

    def timed_raw(curve, xs, lsb, zero):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = raw(curve, xs, lsb, zero)
        end.record()
        events.append((curve, (xs, lsb, zero), out, start, end))
        return out

    mul, coeff_calls = pntt.mul_elementwise, []

    def kept_mul(a, b):
        out = mul(a, b)
        coeff_calls.append((a, b, out))
        return out

    with tempfile.TemporaryDirectory(prefix="bm_textkey_") as tmp:
        shutil.copy(vk_path, tmp)
        dc.decompress_raw, pntt.mul_elementwise = timed_raw, kept_mul
        kn.reset_counts()
        t0 = time.perf_counter()
        try:
            dpk = keys.load_or_build(txt, tmp, device=dev, timings=timings)
            torch.cuda.synchronize()
        finally:
            dc.decompress_raw, pntt.mul_elementwise = raw, mul
        total = time.perf_counter() - t0
        counts = kn.counts()
        check_launches("text-key load path", counts, list(KEYLOAD_LAUNCHES),
                       [k for k in kn.K if k not in KEYLOAD_LAUNCHES])
        if any(counts[k] != v for k, v in KEYLOAD_LAUNCHES.items()):
            raise RuntimeError(f"text-key load path: launches {counts}, "
                               f"not {KEYLOAD_LAUNCHES}")
        digests = key_digests(tmp, name)
    if digests["all"] != KEY_SHA256[name]:
        raise AssertionError(f"{name}: the loaded text key's digest "
                             f"{digests['all']} != KEY_SHA256's")
    log(f"  {name} text key loaded equal to KEY_SHA256's (every DevicePK "
        f"array and the vk)")
    summary.update({k: round(v, 3) for k, v in timings.items()},
                   total_s=round(total, 3))
    for curve, args, out, start, end in events:
        xs, zero = args[0], args[2]
        kname = f"decompress_{curve}"
        products, moved = decompress_products(curve, zero), \
            decompress_bytes(xs)
        res = check_kernel(
            kname, f"{name} key, {curve} n={xs.shape[0]}",
            lambda: raw(curve, *args),
            lambda: kn.plain_by_rows(dc.PLAIN[curve], *args,
                                     rows=PLAIN_CHECK_ROWS))
        if not same(out, raw(curve, *args)):
            raise AssertionError(f"{kname}: the load's result differs from "
                                 f"a second launch")
        record_kernel(report, kname, res, products, moved, primary=True)
        b_ms, b_by = bound(products, moved)
        summary[kname] = {
            "points": xs.shape[0], "ms": round(start.elapsed_time(end), 4),
            "bound_ms": round(b_ms, 4), "bound_by": b_by,
            "plain_ms": round(res[2], 1)}
    for a, b, out in coeff_calls:
        res = check_kernel(
            "mul_elementwise", f"{name} key coefficients x R^2 row, "
            f"n={a.shape[0]}", lambda: mul(a, b),
            lambda: kn.plain_by_rows(lambda r: pntt.mul_elementwise_plain(
                r, b), a, rows=PLAIN_CHECK_ROWS))
        if not same((out,), (mul(a, b),)):
            raise AssertionError("mul_elementwise: the load's result "
                                 "differs from a second launch")
        record_kernel(report, "mul_elementwise", res, a.shape[0],
                      nbytes(a, b) + nbytes(out))
    t0 = time.perf_counter()
    prover = Prover(dpk, dev)
    proof = prover.prove(primary, aux, r=1, s=2)
    same_proof = (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)
    ok = verifier.verify(vk, primary, proof)
    log(f"  proof at (1, 2) from the loaded key: equal to the keygen key's "
        f"{same_proof}, verified {ok} ({time.perf_counter() - t0:.1f}s)")
    if not (same_proof and ok):
        raise AssertionError(f"{name}: the text key's proof differs or "
                             f"fails to verify")
    del prover
    summary["python_reader_sample"] = reader_sample(txt)
    log(f"  text key summary: {json.dumps(summary)}")
    return [counts]


def phase3(dev, report):
    """Mint end to end (run_circuit), then mint's own checks: wire_widen
    and the witness's upload (widen_parity), K2 on the witness and
    qap_matvec on the key's CSR (qap_parity), msm_round on the
    proof's streams, the lane sweep and a profiled proof. Returns the
    paths' launch counts."""
    prover, primary, aux, path_counts = run_circuit("mint", dev)
    log("  add, double, mixed_add and mixed_add_noexc run on neither path; "
        "phase 1 holds them against their plain versions")
    widen_parity("mint", prover, primary, aux, report)
    qap_parity(prover, primary, aux, report)
    mint_stream_parity(prover, report)
    lane_sweep(prover)
    profile_prove(prover, primary, aux)
    return path_counts


def phase4(name, dev, report):
    """Circuit `name` end to end (run_circuit); on deposit and deposit20
    the witness's way to the card (widen_parity); on a basic domain the
    whole QAP witness map on the card against its plain path on the card
    (qap_h_parity); on deposit20, the one circuit whose MSMs take c = 13,
    the MSM's four kernels against their plain versions on the proof's own
    A and H streams (stream_parity). Returns the paths' launch counts."""
    from blockmaze_tpu_torch.msm import pippenger as pp
    prover, primary, aux, path_counts = run_circuit(name, dev)
    if name in ("deposit", "deposit20"):
        widen_parity(name, prover, primary, aux, report)
    if domain_kind(prover.domain) == "basic":
        qap_h_parity(name, prover, primary, aux, report)
    if name == "deposit20":
        for stream in ("A", "H"):
            pts, sc = prover.msm_inputs[stream]
            _, blind = pp.make_blind("g1", dev)
            stream_parity("g1", pts, pp.live_stream(pts, sc, prover.window),
                          blind, prover.window, f"{name} {stream}",
                          check_kernel, functools.partial(record_kernel,
                                                          report))
    return path_counts


def matrix_stats(name, prover):
    """Each constraint matrix of the key's CSR (after keygen's A/B swap; A
    with its input-consistency rows): terms, longest row, rows a warp sums
    (more than keys.LONG_ROW terms) and empty rows."""
    from blockmaze_tpu_torch.groth16 import keys
    m, csr = prover.domain.m, prover.csr
    counts = (csr.ptr[1:] - csr.ptr[:-1]).reshape(3, m)
    for mat, c in zip("ABC", counts):
        log(f"  {name} {mat}: {int(c.sum())} terms, longest row "
            f"{int(c.max())}, {int((c > keys.LONG_ROW).sum())} rows over "
            f"{keys.LONG_ROW} terms, {int((c == 0).sum())} empty rows of {m}")


def qap_h_plain(domain, csr, w, T, std):
    """qap.qap_h_arrays on a basic domain as its kernels' plain versions:
    the matvec, three iFFTs (1/m) and coset FFTs, (A*B - C)/Z, and the
    inverse coset FFT (1/m, coset^-1)."""
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.groth16 import qap
    from blockmaze_tpu_torch.ntt import pntt
    aA, aB, aC = (pntt.fft_plain(
        pntt.fft_plain(x, T["perm"], T["inv"], scale=T["minv"]),
        T["perm"], T["fwd"], pre=T["coset"])
        for x in qap.qap_matvec_plain(csr, w).reshape(3, domain.m, tf.N))
    H = pntt.qap_combine_plain(aA, aB, aC, T["zinv"])
    return pntt.fft_plain(H, T["perm"], T["inv"], scale=T["minv"],
                          post=T["coset_inv_std" if std else "coset_inv"])


def qap_h_parity(name, prover, primary, aux, report):
    """The QAP witness map of a basic-domain circuit (qap.qap_h_arrays, as
    the prover runs it: H in standard form) on the card against its plain
    path on the card, on the circuit's own CSR and witness, bit-exact."""
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.groth16 import qap
    from blockmaze_tpu_torch.ntt import pntt
    dev = prover.device
    std = tf.to_tensor(tf.ints_to_limbs([1] + list(primary) + list(aux)),
                       dev)
    w = pntt.mul_elementwise(std, prover._r2)
    res = check_kernel(
        "qap_h_arrays", f"{name} m={prover.domain.m} basic, own CSR+witness",
        lambda: qap.qap_h_arrays(prover.domain, prover.csr, w,
                                 prover.tables, std=True),
        lambda: qap_h_plain(prover.domain, prover.csr, w, prover.tables,
                            True), reps=5)
    for k in ("fft", "qap_matvec", "qap_combine"):
        report[k]["max_abs_err"] = max(report[k].get("max_abs_err", 0),
                                       res[0])


def copy_ms(src, dev, reps: int = 10) -> float:
    """Milliseconds of one blocking copy of src (a host tensor) to dev,
    host clock around reps copies after a warm one."""
    src.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        src.to(dev)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def widen_parity(name, prover, primary, aux, report):
    """The witness's way to the card: wire_widen against its plain version
    on the card on the circuit's own words and wide rows (the kernel
    table's row at mint, deposit and deposit20) and on a block of wide
    rows alone (2^64 - 1 beside 2^64 at its ends), both equal to
    ints_to_limbs; the Prover's own _limbs and _upload (the words from
    its pinned buffer) equal to the route they replace,
    mul_elementwise(to_tensor(ints_to_limbs(wires))) by R^2; and the
    blocking copy of the words from pinned memory beside the pageable
    copies of the words and of the 64-byte limb rows."""
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.groth16.prover import (_wire_words, wire_widen,
                                                    wire_widen_plain)
    from blockmaze_tpu_torch.ntt import pntt
    dev = prover.device
    wires = [1] + list(primary) + list(aux)
    n = len(wires)
    limbs = tf.ints_to_limbs(wires)
    old = tf.to_tensor(limbs, dev)
    words, wide = _wire_words(primary, aux, np.empty(n, np.int64))
    k = len(wide)
    wd, wided = (torch.from_numpy(a).to(dev) for a in (words, wide))
    res = check_kernel(
        "wire_widen", f"{name} witness: {n} words, {k} wide rows",
        lambda: wire_widen(wd, wided), lambda: wire_widen_plain(wd, wided),
        reps=20)
    if not torch.equal(wire_widen(wd, wided), old):
        raise AssertionError(f"wire_widen: {name}'s limbs differ from "
                             f"ints_to_limbs")
    moved = (8 + ROW) * n + (4 * (1 + tf.N) + ROW) * k
    record_kernel(report, "wire_widen", res, 0, moved,
                  tag=None if name == "mint" else name)
    # the events above time back-to-back wrapper calls, whose host side
    # outlasts so short a kernel; the profiler gives the device's own time
    _, rows, _, _ = profiled(lambda: [wire_widen(wd, wided)
                                      for _ in range(10)])
    dev_ms = sum(us for key, us, _, is_dev in rows
                 if is_dev and "wide" in key) / 10 / 1e3
    log(f"  {'':<16} device time (profiler) {dev_ms:.5f} ms a call")
    report["wire_widen"].setdefault("device_ms", {})[name] = dev_ms
    block = [2**64 - 1, 2**64] + [2**64 + 3 * i for i in range(1 << 16)] \
        + [2**256 - 1, 2**64]
    bw, bwide = _wire_words([], block, np.empty(len(block) + 1, np.int64))
    bwd, bwided = (torch.from_numpy(a).to(dev) for a in (bw, bwide))
    check_kernel("wire_widen", f"{len(bwide)} of {len(bw)} rows wide",
                 lambda: wire_widen(bwd, bwided),
                 lambda: wire_widen_plain(bwd, bwided))
    if not torch.equal(wire_widen(bwd, bwided),
                       tf.to_tensor(tf.ints_to_limbs([1] + block), dev)):
        raise AssertionError("wire_widen: the wide block differs from "
                             "ints_to_limbs")
    t0 = time.perf_counter()
    wide_p, _ = prover._limbs(primary, aux)
    std, mont = prover._upload(wide_p)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    if not (torch.equal(std, old) and torch.equal(
            mont, pntt.mul_elementwise(old, prover._r2))):
        raise AssertionError(f"{name}: the Prover's wires differ from "
                             f"mul_elementwise(to_tensor(ints_to_limbs))")
    pinned = prover._words
    if not pinned.is_pinned():
        raise AssertionError(f"{name}: the Prover's words are not pinned")
    copies = {}
    for label, src in (("pinned words", pinned),
                       ("pageable words", torch.from_numpy(words)),
                       ("pageable 64-B rows", torch.from_numpy(
                           limbs.view(np.int32)))):
        ms = copy_ms(src, dev)
        copies[label] = {"MB": src.nbytes / 1e6, "ms": ms,
                         "GB_per_s": src.nbytes / ms / 1e6}
    log(f"  {name} witness to the card: _limbs + _upload {t_path * 1e3:.2f}"
        f" ms, {k} wide rows; blocking copies: " + "; ".join(
            f"{label} {c['MB']:.2f} MB {c['ms']:.3f} ms "
            f"({c['GB_per_s']:.2f} GB/s)" for label, c in copies.items()))
    report["wire_widen"].setdefault("copies", {})[name] = copies


def qap_parity(prover, primary, aux, report):
    """The witness's Montgomery form on the card (mul_elementwise by R^2,
    the kernel table's row for K2, the main path's one launch of it)
    against its plain version, timed beside the host conversion it
    replaced; qap_matvec against its plain version on the mint key's own
    CSR and witness (the stacked A, B and C), timed with its bound; then
    the QAP witness map of the last proof once more under
    torch.cuda.set_sync_debug_mode("error"), which raises if anything in
    it waits for the device, and equal to a run without it."""
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.groth16 import qap
    from blockmaze_tpu_torch.ntt import pntt
    dev = prover.device
    m, csr = prover.domain.m, prover.csr
    wires = [1] + list(primary) + list(aux)
    t0 = time.perf_counter()
    tf.to_mont_host(tf.FR, wires)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    std = tf.to_tensor(tf.ints_to_limbs(wires), dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    r2 = tf.to_tensor(tf.FR.r2_limbs[None], dev)
    record_kernel(report, "mul_elementwise", check_kernel(
        "mul_elementwise", f"mint witness ({len(wires)}, 16) x R^2 row",
        lambda: pntt.mul_elementwise(std, r2),
        lambda: pntt.mul_elementwise_plain(std, r2), reps=20),
        len(wires), 2 * nbytes(std) + nbytes(r2), primary=True)
    log(f"  witness of {len(wires)} wires on this host: to_mont_host (the "
        f"host conversion the prover no longer runs) {t_host * 1e3:.1f} ms; "
        f"ints_to_limbs + upload (still run) {t_up * 1e3:.1f} ms")
    w = pntt.mul_elementwise(std, r2)
    nnz = csr.var.shape[0]
    used = int(torch.unique(csr.var).numel())
    record_kernel(report, "qap_matvec", check_kernel(
        "qap_matvec", f"mint CSR rows={3 * m} terms={nnz} "
        f"warp rows={csr.long_rows.shape[0]}",
        lambda: qap.qap_matvec(csr, w),
        lambda: qap.qap_matvec_plain(csr, w), reps=10),
        nnz, nnz * (4 + ROW) + nbytes(csr.ptr, csr.long_rows)
        + used * ROW + 3 * m * ROW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        H = qap.qap_h_arrays(prover.domain, csr, w, prover.tables, std=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t_enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    again = qap.qap_h_arrays(prover.domain, csr, w, prover.tables, std=True)
    if not torch.equal(H, again):
        raise AssertionError("qap_h_arrays differs between two runs")
    log(f"  qap_h_arrays under set_sync_debug_mode('error'): no sync; "
        f"enqueued in {t_enqueue * 1e3:.2f} ms, done in {t_all * 1e3:.2f} ms"
        f"; equal to a second run: True")


def digit_stats(prover):
    """Per MSM of the prover's last proof, on the points and scalars it
    gave the MSM: the share of nonzero c-bit digits, the live items and
    the lanes (T of L items) msm cuts them into, and the longest run of
    equal keys, in items and in lanes. Returns {MSM: [live, T, L]}."""
    from blockmaze_tpu_torch.msm import pippenger as pp
    c = prover.window
    out = {}
    for name, (pts, sc) in prover.msm_inputs.items():
        d = pp.digits(sc, c)
        keys, _, _ = pp.live_stream(pts, sc, c)
        live = keys.shape[0]
        T, L = pp.lane_cut(live, prover.lanes) if live else (0, 0)
        run = int(torch.unique_consecutive(keys, return_counts=True)[1]
                  .max()) if live else 0
        log(f"  msm {name}: n={sc.shape[0]}, nonzero digits "
            f"{float((d != 0).double().mean()):.4f}, live items {live}, "
            f"T={T} L={L}, longest run {run} items = "
            f"{run / max(L, 1):.1f} lanes")
        out[name] = [live, T, L]
    return out


def mint_stream_parity(prover, report):
    """msm_round on the five live streams of the last mint proof, cut as the
    prover cuts them, blinded: kernel time and bound for each, and the
    plain version bit-exact on the sparse A and the dense H stream. The
    kernel table's msm_round row is the H stream's (the main path's
    heaviest launch); the sums are per proof."""
    from blockmaze_tpu_torch.msm import pippenger as pp
    c = prover.window
    tot_ms = tot_bound = 0.0
    for name, (pts, sc) in prover.msm_inputs.items():
        curve = "g2" if name == "B g2" else "g1"
        keys, pids, drop = pp.live_stream(pts, sc, c)
        live = keys.shape[0]
        T, L = pp.lane_cut(live, prover.lanes)
        keys, pids = pp.pad_stream(keys, pids, drop, T, L)
        _, blind = pp.make_blind(curve, pts[0].device)

        def kern():
            return flat_acc(pp.accumulate(curve, keys, pids, pts, blind, T,
                                          L, drop))

        products = live * PRODUCTS[curve]["madd"]
        moved = accumulate_bytes(curve, keys, pids, live, pts, T, drop)
        shape = f"mint {name} live={live} T={T} L={L}"
        if name in ("A", "H"):
            res = check_kernel(
                "msm_round", shape, kern,
                lambda: flat_acc(pp.accumulate_plain(
                    curve, keys, pids, pts, blind, T, L, drop)), reps=5)
            record_kernel(report, "msm_round", res, products, moved,
                          primary=name == "H")
            ms = res[1]
        else:
            ms = timed(kern, 5)
            b_ms, b_by = bound(products, moved)
            log(f"  {'msm_round':<16} {shape:<40} kernel {ms:.4f} ms")
            log(f"  {'':<16} bound {b_ms:.5f} ms ({b_by}: {products} "
                f"products, {moved} bytes)")
        tot_ms += ms
        tot_bound += bound(products, moved)[0]
    log(f"  msm_round per mint proof (5 streams): kernel {tot_ms:.4f} ms, "
        f"bound {tot_bound:.5f} ms")


def lane_sweep(prover):
    """Device ms per mint proof of what the lane cut changes, msm_round plus
    msm_combine over the five live streams of the last proof (blinded;
    CUDA events, 3 launches each), for each most-lanes and fewest-items
    value: the combine's partials grow with the lanes, the accumulation's
    chains with the items a lane."""
    from blockmaze_tpu_torch.msm import pippenger as pp
    c = prover.window
    streams = []
    for name, (pts, sc) in prover.msm_inputs.items():
        curve = "g2" if name == "B g2" else "g1"
        streams.append((curve, pts, pp.live_stream(pts, sc, c),
                        pp.make_blind(curve, pts[0].device)[1]))

    def cost(curve, pts, stream, blind, lanes, min_items):
        keys, pids, drop = stream
        T, L = pp.lane_cut(keys.shape[0], lanes, min_items)
        keys, pids = pp.pad_stream(keys, pids, drop, T, L)
        acc_ms = timed(lambda: pp.accumulate(curve, keys, pids, pts, blind,
                                             T, L, drop), 3)
        acc, meta, head, bkt, cnt = pp.accumulate(curve, keys, pids, pts,
                                                  blind, T, L, drop)
        parts = pp.boundary_partials(curve, acc, meta, head)
        cnt = cnt.to(torch.int64)
        return acc_ms + timed(lambda: pp.combine(curve, *parts, bkt, cnt,
                                                 drop), 3)

    log(f"  lane sweep: msm_round + msm_combine device ms per mint proof "
        f"(prover: lanes={prover.lanes}, min_items={pp.MIN_ITEMS})")
    for lanes in (8192, 16384, 32768, 65536, 131072):
        row = []
        for min_items in (2, 4, 8, 16, 32):
            ms = sum(cost(*st, lanes, min_items) for st in streams)
            row.append(f"min_items={min_items}: {ms:.4f}")
        log(f"    lanes={lanes}: " + ", ".join(row))


# ---------------------------------------------------------------------------
# Phase 5: the zktx service and the node lifecycle with real proofs
# ---------------------------------------------------------------------------

def phase5(depth: int, dev):
    """scripts/lifecycle.py on the port, through the port's driver
    (blockmaze_tpu_torch.scripts.lifecycle): ZkTx on cuda:0 at Merkle
    depth `depth` over phases 3-4's keys, warm(), then run_lifecycle: a
    Network with alice and bob Nodes in temporary datadirs, mint 100 ->
    send 40 -> deposit -> redeem 25 with a block mined after each; every
    proof verified at pool admission and at block import; the balances of
    lifecycle.py:73-76; a double deposit rejected; alice's wallet reloaded
    from its datadir. Per transaction: synthesis, prove (with phases) and
    verify seconds, and the proof's launches against its domain kind's
    prove path. Returns the transactions' launch counts."""
    from blockmaze_tpu_torch.scripts import lifecycle
    from blockmaze_tpu_torch.zktx.api import ZkTx

    t0 = time.perf_counter()
    svc = ZkTx(lifecycle.service_keys(depth), merkle_depth=depth,
               device=dev)
    svc.warm()
    torch.cuda.synchronize()
    log(f"  ZkTx(depth {depth}).warm(): {time.perf_counter() - t0:.1f}s "
        f"(keys, Provers, kernel library)")
    kinds = {n: domain_kind(svc.circuits[n].prover.domain)
             for n in lifecycle.SERVICE_CIRCUITS}
    path_counts, _ = lifecycle.run_lifecycle(
        svc, lambda name, counts: check_prove_counts(kinds[name], counts, 1))
    return path_counts


# ---------------------------------------------------------------------------
# Phase 6: Prover.prove_batch
# ---------------------------------------------------------------------------

BATCHES = {"mint": (1, 2, 4, 8), "deposit": (1, 4)}


def phase6(name: str, dev):
    """Prover.prove_batch on `name` (mint: step domain; deposit: basic,
    2^19) through the depth-8 service's Prover: four distinct witnesses; a
    batch at given (rs, ss) whose proofs each verify, each equal prove at
    the same (r, s), and fail against another instance's primary input;
    then batches of B proofs (BATCHES; witnesses repeated past four, (r, s)
    random) timed beside B x the steady single proof of the same run, each
    proof verified, the launches per proof within the prove path's; mint's
    B = 4 batch once more under torch.profiler for the device's busy
    share. Returns the batches' launch counts."""
    from blockmaze_tpu_torch.groth16 import verifier
    from blockmaze_tpu_torch.scripts import lifecycle
    from blockmaze_tpu_torch.scripts.batch import batch_instance
    from blockmaze_tpu_torch.utils import kernels as kn
    from blockmaze_tpu_torch.zktx.api import ZkTx

    t0 = time.perf_counter()
    insts = [batch_instance(name, i) for i in range(4)]
    log(f"  {name}: 4 witnesses in {time.perf_counter() - t0:.1f}s "
        f"(not timed below)")
    ctx = ZkTx(lifecycle.service_keys(8), merkle_depth=8,
               device=dev).circuits[name]
    prover, vk = ctx.prover, ctx.vk
    kind = domain_kind(prover.domain)
    prover.prove(*insts[0])
    single = []
    for i in range(3):
        t0 = time.perf_counter()
        prover.prove(*insts[i + 1])
        single.append(time.perf_counter() - t0)
    one = sorted(single)[1]
    log(f"  steady single proofs: {[round(t, 4) for t in single]} s, "
        f"median {one:.4f}s")

    rs, ss = [1, 2, 3, 4], [51, 52, 53, 54]
    path_counts = []
    kn.reset_counts()
    t0 = time.perf_counter()
    proofs = prover.prove_batch(insts, rs=rs, ss=ss)
    torch.cuda.synchronize()
    path_counts.append(kn.counts())
    log(f"  first prove_batch (B=4; starts the combine thread): "
        f"{time.perf_counter() - t0:.3f}s")
    check_prove_counts(kind, path_counts[-1], 4)
    for i, proof in enumerate(proofs):
        want = prover.prove(*insts[i], r=rs[i], s=ss[i])
        if (proof.a, proof.b, proof.c) != (want.a, want.b, want.c):
            raise AssertionError(f"{name} batch proof {i} != prove at equal "
                                 f"(r, s)")
        if not verifier.verify(vk, insts[i][0], proof):
            raise AssertionError(f"{name} batch proof {i} rejected")
    if verifier.verify(vk, insts[1][0], proofs[0]):
        raise AssertionError(f"{name} batch proof 0 accepted for instance 1")
    log(f"  prove_batch of 4 at (rs, ss) = ({rs}, {ss}): each verified, "
        f"each equal to prove at its (r, s); proof 0 rejected for "
        f"instance 1's input")

    rows = []
    for B in BATCHES[name]:
        batch = [insts[i % 4] for i in range(B)]
        kn.reset_counts()
        t0 = time.perf_counter()
        proofs = prover.prove_batch(batch)
        dt = time.perf_counter() - t0
        path_counts.append(kn.counts())
        check_prove_counts(kind, path_counts[-1], B)
        if not all(verifier.verify(vk, p_a[0], p)
                   for p_a, p in zip(batch, proofs)):
            raise AssertionError(f"{name} batch of {B}: a proof rejected")
        phases = {k: round(v, 4) for k, v in prover.timings.items()}
        rows.append({"B": B, "s": round(dt, 4),
                     "proofs_per_s": round(B / dt, 2),
                     "B_x_single_s": round(B * one, 4), "phases": phases})
        log(f"  prove_batch B={B}: {dt:.4f}s = {B / dt:.2f} proofs/s "
            f"(B x single proof {B * one:.4f}s = {1 / one:.2f} proofs/s); "
            f"phases {json.dumps(phases)}; all verified")
    summary = {"circuit": name, "domain": kind, "single_s": round(one, 4),
               "batches": rows}
    if name == "mint":
        wall, _, busy, _ = profiled(lambda: prover.prove_batch(insts))
        summary["profiled_B4"] = {"wall_s": round(wall, 4),
                                  "busy_s": round(busy, 4)}
        log(f"  profiled prove_batch B=4: wall {wall:.3f}s (profiler on), "
            f"device busy {busy * 1e3:.1f} ms = {100 * busy / wall:.1f}%")
    prover.close()
    log(f"  batch summary: {json.dumps(summary)}")
    return path_counts


def profiled(fn):
    """Run fn once under torch.profiler: (wall s, rows, device busy s, sum
    over every row s). Busy time sums the device's own rows (kernels,
    copies) once each; an operator's row repeats the device time of the
    kernels it launched, so the sum over every row counts torch's own
    kernels twice. rows: (key, device us, count, is a device row), most
    device time first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = [(e.key, dev_us(e), e.count, e.device_type == DeviceType.CUDA)
            for e in prof.key_averages() if dev_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows if r[3]) / 1e6
    return wall, rows, busy, sum(r[1] for r in rows) / 1e6


def profile_prove(prover, primary, aux):
    """One more steady proof under torch.profiler: device time by kernel
    and the device's busy share of the proof's wall time."""
    wall, rows, busy, every_row = profiled(lambda: prover.prove(primary, aux))
    phases = {k: round(v, 4) for k, v in prover.timings.items()}
    log(f"  profiled steady prove: wall {wall:.3f}s (profiler on), device "
        f"busy {busy * 1e3:.1f} ms = {100 * busy / wall:.1f}% of wall "
        f"(sum over every profiler row {every_row * 1e3:.1f} ms); "
        f"phases {json.dumps(phases)}")
    for key, us, n, _ in [r for r in rows if r[3]][:16]:
        log(f"    {us / 1e3:9.3f} ms  {n:6d}x  {key[:90]}")
    log("  the port's kernels in that proof (device ms, launches):")
    for tag in ("accumulate_kernel<bm::Fq,", "accumulate_kernel<bm::Fq2,",
                "fft_pass_kernel", "butterfly_stage_kernel",
                "mul_elementwise_kernel", "qap_matvec_kernel",
                "step_pre_kernel", "step_post_kernel", "qap_combine_kernel",
                "combine_kernel<bm::Fq>",
                "combine_kernel<bm::Fq2>", "triangle_kernel<bm::Fq>",
                "triangle_kernel<bm::Fq2>", "fold_kernel<bm::Fq>",
                "fold_kernel<bm::Fq2>", "widen_kernel", "wide_rows_kernel",
                "Memcpy HtoD", "aten::sort", "RadixSort", "aten::nonzero"):
        hit = [(us, n) for key, us, n, _ in rows if tag in key]
        log(f"    {tag:<30} {sum(u for u, _ in hit) / 1e3:9.3f} ms "
            f"{sum(n for _, n in hit):5d}x")


# ---------------------------------------------------------------------------
# Phase 7: the mesh (parallel/)
# ---------------------------------------------------------------------------

def sync_all(devices):
    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)


def wall_ms(fn, devices, reps: int = 3) -> float:
    """Milliseconds per call of fn by the host clock, every device synced
    before and after (a mesh's work spans cards); one warm call first."""
    fn()
    sync_all(devices)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all(devices)
    return (time.perf_counter() - t0) * 1e3 / reps


def make_phase7_mesh(dev):
    """MESH_SHARDS shards: the first MESH_SHARDS cards when that many are
    visible, else MESH_SHARDS shards on dev (an explicit device list)."""
    from blockmaze_tpu_torch.parallel import mesh as pm
    cards = torch.cuda.device_count()
    if cards >= MESH_SHARDS:
        mesh = pm.make_mesh(MESH_SHARDS)
        how = "one card a shard"
    else:
        mesh = pm.Mesh([dev] * MESH_SHARDS)
        how = f"all {MESH_SHARDS} shards share {dev}"
    log(f"  torch.cuda.device_count() = {cards}; mesh of {mesh.size} "
        f"shards, {how}: {[str(d) for d in mesh.devices]}")
    return mesh


def other_card_parity(rng):
    """With cuda:0 current, kernels on cuda:1 tensors: mul_elementwise and
    fft against their plain versions there, and an MSM (msm_combine and
    msm_triangle set their shared-memory attribute per device) against
    the same MSM on cuda:0 and its closed form."""
    from blockmaze_tpu_torch.curves import host_curve as HC
    from blockmaze_tpu_torch.curves import tcurve as tc
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.fields.constants import R_MOD
    from blockmaze_tpu_torch.msm import pippenger as pp
    from blockmaze_tpu_torch.ntt import domain as TD
    from blockmaze_tpu_torch.ntt import pntt, tntt
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    with torch.cuda.device(d0):
        a, b = rand_field(rng, (1 << 16,), d1), rand_field(rng, (1 << 16,), d1)
        check_kernel("mul_elementwise", "on cuda:1, cuda:0 current",
                     lambda: pntt.mul_elementwise(a, b),
                     lambda: pntt.mul_elementwise_plain(a, b))
        T = tntt.tables_to(tntt.qap_tables(TD.get_evaluation_domain(1 << 16)),
                           d1)
        check_kernel("fft", "2^16 on cuda:1, cuda:0 current",
                     lambda: pntt.fft(a, T["perm"], T["fwd"]),
                     lambda: pntt.fft_plain(a, T["perm"], T["fwd"]))
        n = 1 << 14
        pts0 = curve_points("g1", n, d0)
        pts1 = tuple(t.to(d1) for t in pts0)
        py = random.Random(SEED + 1)
        ks = [py.randrange(R_MOD) for _ in range(n)]
        sc = tf.to_tensor(tf.ints_to_limbs(ks), d0)
        c = pp.default_window(n)
        got = [tc.g1_jacobian_to_host(tuple(
            v[None] for v in pp.msm("g1", p, sc.to(p[0].device), c,
                                    pp.MAX_LANES)))[0] for p in (pts1, pts0)]
        want = HC.g1_mul(HC.g1_generator(),
                         sum((i + 1) * k for i, k in enumerate(ks)) % R_MOD)
        if torch.cuda.current_device() != 0 or got != [want, want]:
            raise AssertionError("msm on cuda:1 with cuda:0 current differs")
        log(f"  msm G1 2^14 on cuda:1 (cuda:0 current) = on cuda:0 = "
            f"closed form: True")


def mesh_tables(mesh, domain):
    """The single-card tables of `domain` on the lead device and its
    sharded ones on the mesh; logs the sharded tables' host and upload
    seconds (step 2's twiddles are m host products, built once a
    process per domain and mesh size)."""
    from blockmaze_tpu_torch.ntt import tntt
    from blockmaze_tpu_torch.parallel import sntt
    T1 = tntt.tables_to({**tntt.qap_tables(domain),
                         **tntt.std_tables(domain)}, mesh.lead)
    t0 = time.perf_counter()
    host = sntt.sqap_tables(domain, mesh.size)
    t_host = time.perf_counter() - t0
    TS = sntt.tables_to(host, mesh)
    sync_all(mesh.devices)
    log(f"  sharded tables m={domain.m} {domain_kind(domain)}: host "
        f"{t_host:.2f}s (cached after), upload "
        f"{time.perf_counter() - t0 - t_host:.2f}s")
    return T1, TS


def batched_fft_parity(mesh, plans, rng, report, rows):
    """pntt.fft on one shard's batches at the sharded shapes, against
    fft_plain on the same tensors, timed with its bound: step 1's batch of
    m2 / n column FFTs of m1 (step 2's twiddles as its post factor, a
    coset FFT's powers as its pre) and step 4's m1 / n row FFTs of m2 (an
    inverse's 1/m as its scale, coset^-1 as its post). plans: (label,
    plan, {step: factors}); appends a row per case to rows."""
    from blockmaze_tpu_torch.ntt import pntt
    n = mesh.size
    for label, plan, factors in plans:
        m1, m2 = plan["m1"], plan["m2"]
        S = plan["shards"][0]
        for step, (perm, tw, B, mk) in (("1", (S["p1"], S["t1"], m2 // n,
                                                m1)),
                                         ("4", (S["p2"], S["t2"], m1 // n,
                                                m2))):
            f = dict(factors.get(step, {}))
            if step == "1":
                f["post"] = S["tw"]
            a = rand_field(rng, (B * mk,), S["p1"].device)
            k = mk.bit_length() - 1
            res = check_kernel(
                "fft", f"{label} step {step}: {B} x 2^{k} "
                f"{'+'.join(sorted(f)) or 'no factors'}",
                lambda: pntt.fft(a, perm, tw, **f),
                lambda: pntt.fft_plain(a, perm, tw, **f), reps=20)
            products = B * k * mk // 2 + B * mk * sum(
                1 for v in f.values() if v.numel() > 16) + (
                B * mk if "scale" in f else 0)
            moved = 2 * nbytes(a) + nbytes(perm, tw, *f.values())
            b_ms, b_by = bound(products, moved)
            log(f"  {'':<16} bound {b_ms:.5f} ms ({b_by}: {products} "
                f"products, {moved} bytes)")
            report["fft"]["max_abs_err"] = max(report["fft"].get(
                "max_abs_err", 0), res[0])
            rows.append({"shape": f"{label} step {step} {B}x2^{k}",
                         "ms": round(res[1], 5), "plain_ms": round(res[2], 3),
                         "bound_ms": round(b_ms, 5)})


def mesh_fft_parity(mesh, dev, rng, report, summary):
    """The batched fft at the sharded shapes (mint's 2^17 = 256 x 512 and
    2^16 = 256 x 256, deposit20's 2^20 = 1024 x 1024), then the sharded
    FFT, inverse, coset FFT and inverse coset FFT (standard form) at basic
    2^18 and 2^20 and at mint's step domain, each equal to the
    single-card tntt result and timed beside it."""
    from blockmaze_tpu_torch.ntt import domain as TD
    from blockmaze_tpu_torch.ntt import tntt
    from blockmaze_tpu_torch.parallel import sntt
    doms = [TD.get_evaluation_domain(1 << 18),
            TD.get_evaluation_domain(1 << 20),
            TD.get_evaluation_domain((1 << 17) + (1 << 16))]
    tabs = [mesh_tables(mesh, d) for d in doms]
    T20, T_mint = tabs[1][1], tabs[2][1]
    rows = []
    batched_fft_parity(mesh, [
        ("mint big 2^17 fwd", T_mint["big_fwd"], {}),
        ("mint big 2^17 inv", T_mint["big_inv"], {}),
        ("mint small 2^16 fwd", T_mint["small_fwd"], {}),
        ("mint small 2^16 inv", T_mint["small_inv"], {}),
        ("2^20 fwd coset", T20["fwd"], {"1": {"pre": T20["coset"][0]}}),
        ("2^20 inv 1/m coset^-1 std", T20["inv"],
         {"4": {"scale": T20["minv"][0],
                "post": T20["coset_inv_std"][0]}})], rng, report, rows)
    summary["batched_fft"] = rows
    out = []
    for d, (T1, TS) in zip(doms, tabs):
        a = rand_field(rng, (d.m,), dev)
        for op, one, sharded in (
                ("fft", lambda: tntt.fft_t(d, a, T1),
                 lambda: sntt.s_fft_t(mesh, d, a, TS)),
                ("ifft", lambda: tntt.ifft_t(d, a, T1),
                 lambda: sntt.s_ifft_t(mesh, d, a, TS)),
                ("coset_fft", lambda: tntt.coset_fft_t(d, a, T1),
                 lambda: sntt.s_coset_fft_t(mesh, d, a, TS)),
                ("icoset_fft std", lambda: tntt.icoset_fft_t(d, a, T1, True),
                 lambda: sntt.s_icoset_fft_t(mesh, d, a, TS, True))):
            ok = torch.equal(one(), sharded())
            ms1 = wall_ms(one, mesh.devices, 10)
            msn = wall_ms(sharded, mesh.devices, 10)
            label = f"m={d.m} {domain_kind(d)} {op}"
            log(f"  sharded {label:<34} equal to single card: {ok}; "
                f"single {ms1:.4f} ms, {mesh.size} shards {msn:.4f} ms")
            if not ok:
                raise AssertionError(f"sharded {label} != single card")
            out.append({"op": label, "single_ms": round(ms1, 4),
                        "sharded_ms": round(msn, 4)})
    summary["sharded_fft"] = out


def msm_scaling(mesh, dev, summary):
    """sharded_msm over 1, 2 and 4 shards of the mesh on phase 2's 2^18 G1
    points i*G (placed on their shards first, as a Prover holds them),
    with and without a blind, each equal to (sum_i i*k_i)*G; ms by the
    host clock (all cards synced), Mpoints/s and the efficiency t_1 / (k
    t_k). The counterpart of scripts/scaling.py."""
    from blockmaze_tpu_torch.curves import host_curve as HC
    from blockmaze_tpu_torch.curves import tcurve as tc
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.fields.constants import R_MOD
    from blockmaze_tpu_torch.msm import pippenger as pp
    from blockmaze_tpu_torch.parallel import mesh as pm
    n = 1 << 18
    pts = curve_points("g1", n, dev)
    py = random.Random(SEED)
    ks = [py.randrange(R_MOD) for _ in range(n)]
    sc = tf.to_tensor(tf.ints_to_limbs(ks), dev)
    want = HC.g1_mul(HC.g1_generator(),
                     sum((i + 1) * k for i, k in enumerate(ks)) % R_MOD)
    c = pp.default_window(n)
    rows, base = [], {}
    for k in (1, 2, 4):
        sub = pm.Mesh(mesh.devices[:k])
        shards = sub.shard_points(pts)
        for blinded in (False, True):
            R, blind = pp.make_blind("g1", dev) if blinded else (None, None)

            def run():
                return pm.sharded_msm(sub, "g1", shards, sc, c, pp.MAX_LANES,
                                      blind=blind)

            res = run()
            got = tc.g1_jacobian_to_host(tuple(v[None] for v in res[:3]))[0]
            if blinded:
                got = pp.unblind_msm("g1", got, res[3].cpu().numpy(), R, c)
            ms = wall_ms(run, sub.devices, 3)
            base.setdefault(blinded, ms)
            eff = base[blinded] / (k * ms)
            log(f"  sharded_msm G1 2^18 c={c} over {k} shard(s) "
                f"{'blinded' if blinded else 'unblinded'}: {ms:.3f} ms, "
                f"{n / ms / 1e3:.2f} Mpoints/s, efficiency {eff:.3f}; "
                f"equals (sum i*k_i)*G: {got == want}")
            if got != want:
                raise AssertionError(f"sharded_msm over {k} shards != "
                                     f"closed form")
            rows.append({"shards": k, "blinded": blinded,
                         "ms": round(ms, 3),
                         "mpoints_s": round(n / ms / 1e3, 2),
                         "efficiency": round(eff, 3)})
    summary["msm_scaling"] = rows


def mesh_prove(name, mesh, summary):
    """A Prover on the mesh over circuit `name`'s keys (phases 3-4): three
    proofs, two at (r, s) = (1, 2) each equal to the single-card proof at
    (1, 2), one at random (r, s); all verified; the launches per proof
    against MESH_PATH; phase seconds beside the single-card proof's; then
    one more proof under torch.profiler for the device's busy time.
    Returns (the mesh Prover, [its launches])."""
    from blockmaze_tpu_torch.groth16 import verifier
    from blockmaze_tpu_torch.groth16.prover import Prover
    from blockmaze_tpu_torch.utils import kernels as kn
    prover1, vk, primary, aux, want, single = RUNS[name][:6]
    t0 = time.perf_counter()
    prover = Prover(prover1.dpk, mesh=mesh)
    sync_all(mesh.devices)
    init_s = time.perf_counter() - t0
    kind = domain_kind(prover.domain)
    log(f"  {name}: mesh Prover {init_s:.1f}s (sharded QAP: "
        f"{prover.sharded_qap}; MSM blocks nA/n={prover.nA // mesh.size}, "
        f"nH/n={prover.nH // mesh.size})")
    proofs, times = [], []
    kn.reset_counts()
    for i, (r, s) in enumerate(((1, 2), (1, 2), (None, None))):
        t0 = time.perf_counter()
        proofs.append(prover.prove(primary, aux, r=r, s=s))
        dt = time.perf_counter() - t0
        phases = {k: round(v, 4) for k, v in prover.timings.items()}
        times.append({"s": round(dt, 4), **phases})
        log(f"  {name} mesh prove {i}: {dt:.3f}s phases "
            f"{json.dumps(phases)}")
    sync_all(mesh.devices)
    counts = kn.counts()
    check_prove_counts(kind, counts, len(proofs), MESH_PATH)
    for i, proof in enumerate(proofs):
        if not verifier.verify(vk, primary, proof):
            raise AssertionError(f"{name} mesh proof {i} rejected")
    for i in (0, 1):
        if (proofs[i].a, proofs[i].b, proofs[i].c) != (want.a, want.b,
                                                       want.c):
            raise AssertionError(f"{name} mesh proof {i} != single-card "
                                 f"proof at (1, 2)")
    log(f"  {name}: mesh proofs 0 and 1 equal the single-card proof at "
        f"(1, 2); all three verified")
    wall, _, busy, _ = profiled(lambda: prover.prove(primary, aux))
    log(f"  {name}: profiled mesh proof: wall {wall:.3f}s (profiler on), "
        f"device busy {busy * 1e3:.1f} ms summed over the mesh's cards")
    summary[name] = {"domain": kind, "m": prover.domain.m,
                     "sharded_qap": prover.sharded_qap,
                     "mesh_init_s": round(init_s, 2),
                     "single_steady": single, "mesh_proofs": times,
                     "profiled": {"wall_s": round(wall, 4),
                                  "busy_s": round(busy, 4)}}
    log(f"  {name}: steady proof single card {json.dumps(single)}, mesh "
        f"{json.dumps(times[1])}")
    return prover, [counts]


def mesh_batch(prover, summary):
    """prove_batch of two mint witnesses on the mesh Prover: each proof
    verified, the launches within MESH_PATH. Returns [its launches]."""
    from blockmaze_tpu_torch.groth16 import verifier
    from blockmaze_tpu_torch.scripts.batch import batch_instance
    from blockmaze_tpu_torch.utils import kernels as kn
    vk = RUNS["mint"][1]
    insts = [batch_instance("mint", i) for i in range(2)]
    kn.reset_counts()
    t0 = time.perf_counter()
    proofs = prover.prove_batch(insts)
    dt = time.perf_counter() - t0
    sync_all(prover.mesh.devices)
    counts = kn.counts()
    check_prove_counts(domain_kind(prover.domain), counts, 2, MESH_PATH)
    for (primary, _), proof in zip(insts, proofs):
        if not verifier.verify(vk, primary, proof):
            raise AssertionError("mint mesh batch proof rejected")
    prover.close()
    log(f"  mint prove_batch B=2 on the mesh: {dt:.3f}s (starts the "
        f"combine thread); both verified")
    summary["mint_batch_B2_s"] = round(dt, 3)
    return [counts]


def phase7(dev, rng, report):
    """The mesh (docstring, phase 7). Returns (the mesh paths' launches,
    the `mesh summary` dict)."""
    mesh = make_phase7_mesh(dev)
    summary = {"shards": mesh.size,
               "devices": [str(d) for d in mesh.devices],
               "device_count": torch.cuda.device_count()}
    if torch.cuda.device_count() >= 2:
        other_card_parity(rng)
    mesh_fft_parity(mesh, dev, rng, report, summary)
    msm_scaling(mesh, dev, summary)
    path_counts = []
    for name in MESH_CIRCUITS:
        prover, counts = mesh_prove(name, mesh, summary)
        path_counts += counts
        if name == "mint":
            path_counts += mesh_batch(prover, summary)
    log(f"  mesh summary: {json.dumps(summary)}")
    return path_counts, summary


# ---------------------------------------------------------------------------
# Phase 8: the process mesh (parallel.distributed, ProcessMesh)
# ---------------------------------------------------------------------------

def process_placement():
    """(devices, the backend initialize must choose): with two or more
    cards, ranks one a card over nccl, as many as the largest power of two
    at most min(PROCESS_RANKS, cards) (the padded sizes split evenly only
    over a power of two); else two ranks on cuda:0 over gloo (nccl refuses
    two processes on one card)."""
    cards = torch.cuda.device_count()
    if cards >= 2:
        ranks = 1 << (min(PROCESS_RANKS, cards).bit_length() - 1)
        return [f"cuda:{i}" for i in range(ranks)], "nccl"
    return ["cuda:0", "cuda:0"], "gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(cmds, envs, logs, timeout):
    """Start each command (its output into its log file, its environment
    os.environ updated by its env) and wait for all; any that exits
    nonzero, or the timeout, stops every one and fails with the exit codes
    (or "timeout")."""
    procs = []
    try:
        for cmd, env, path in zip(cmds, envs, logs):
            out = open(path, "w")
            procs.append((out, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                env={**os.environ, **env})))
        t0 = time.perf_counter()
        while True:
            rcs = [p.poll() for _, p in procs]
            if all(rc == 0 for rc in rcs) or any(rc not in (None, 0)
                                                 for rc in rcs):
                break
            if time.perf_counter() - t0 > timeout:
                rcs = ["timeout" if rc is None else rc for rc in rcs]
                break
            time.sleep(0.2)
    finally:
        for out, p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            out.close()
    return rcs


def run_ranks(work, devices):
    """Start one process per device (this script with RANK_FLAG) and wait
    for all; any rank that exits nonzero, or the RANK_TIMEOUT, stops
    every rank and fails. Prints each rank's log; returns their result
    dicts in rank order."""
    port = free_port()
    logs = [os.path.join(work, f"rank{r}.log") for r in range(len(devices))]
    rcs = run_procs(
        [[sys.executable, os.path.abspath(__file__), RANK_FLAG, work, d]
         for d in devices],
        [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
          "WORLD_SIZE": str(len(devices)), "RANK": str(r),
          "LOCAL_RANK": str(r)} for r in range(len(devices))],
        logs, RANK_TIMEOUT)
    for r, path in enumerate(logs):
        with open(path) as f:
            for line in f:
                log(f"  [rank {r}] {line.rstrip()}")
    if any(rc != 0 for rc in rcs):
        raise RuntimeError(f"process mesh ranks exited {rcs}")
    outs = []
    for r in range(len(devices)):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def phase8(summary7):
    """The process mesh (docstring, phase 8): the parent's half. Returns
    every rank's launches on its main path."""
    from blockmaze_tpu_torch.scripts.batch import batch_instance
    from blockmaze_tpu_torch.utils import kernels as kn
    devices, backend = process_placement()
    log(f"  torch.cuda.device_count() = {torch.cuda.device_count()}; "
        f"{len(devices)} ranks on {devices}, backend {backend}")
    with tempfile.TemporaryDirectory() as work:
        pts = curve_points("g1", 1 << 18, torch.device("cuda:0"))
        np.savez(os.path.join(work, "points.npz"),
                 *(t.cpu().numpy() for t in pts))
        for name in MESH_CIRCUITS:
            _, _, primary, aux, proof, _, _ = RUNS[name]
            with open(os.path.join(work, f"{name}.pkl"), "wb") as f:
                pickle.dump((primary, aux, (proof.a, proof.b, proof.c)), f)
        insts = [batch_instance(BATCH_CIRCUIT, i)
                 for i in range(len(BATCH_RS))]
        want = [RUNS[BATCH_CIRCUIT][0].prove(*inst, r=r, s=s)
                for inst, (r, s) in zip(insts, BATCH_RS)]
        with open(os.path.join(work, "batch.pkl"), "wb") as f:
            pickle.dump((insts, [(p.a, p.b, p.c) for p in want]), f)
        t0 = time.perf_counter()
        outs = run_ranks(work, devices)
        log(f"  {len(devices)} ranks: {time.perf_counter() - t0:.1f}s")
    for r, out in enumerate(outs):
        if out["backend"] != backend or out["devices"] != devices:
            raise AssertionError(f"rank {r}: backend {out['backend']} on "
                                 f"{out['devices']}, not {backend} on "
                                 f"{devices}")
    for name in MESH_CIRCUITS:
        if len({json.dumps(o[name]["random_proof"]) for o in outs}) != 1:
            raise AssertionError(f"{name}: the ranks' random-(r, s) proofs "
                                 f"differ")
        check_launches(f"{name} process mesh path, every rank", {
            k: sum(o[name]["launches"][k] for o in outs) for k in kn.K},
            MSM_KERNELS)
    summary = {"ranks": len(devices), "devices": devices,
               "backend": backend,
               "device_count": torch.cuda.device_count(), "rank0": {
                   k: v for k, v in outs[0].items() if k not in MESH_CIRCUITS},
               "proofs": {}}
    for name in MESH_CIRCUITS:
        single = RUNS[name]
        summary["proofs"][name] = {
            "single_steady": single[5], "single_prover_mem": single[6],
            "mesh7_steady": summary7[name]["mesh_proofs"][1],
            "ranks": [{k: o[name][k] for k in ("init_s", "mem", "proofs")}
                      for o in outs]}
        log(f"  {name}: steady proof single card {json.dumps(single[5])}; "
            f"phase 7 mesh {json.dumps(summary7[name]['mesh_proofs'][1])}; "
            f"process mesh rank 0 {json.dumps(outs[0][name]['proofs'][1])}"
            f"; Prover memory single {json.dumps(single[6])}, a rank "
            f"{json.dumps(outs[0][name]['mem'])}")
    batches = [o[BATCH_CIRCUIT]["batch"] for o in outs]
    summary["batch"] = {"B": len(BATCH_RS), "s": [b["s"] for b in batches]}
    log(f"  {BATCH_CIRCUIT} prove_batch of {len(BATCH_RS)} on every rank: "
        f"each proof equal to the single-card proof at its (r, s); "
        f"seconds {summary['batch']['s']}")
    log(f"  process mesh summary: {json.dumps(summary)}")
    return ([o[name]["launches"] for o in outs for name in MESH_CIRCUITS]
            + [b["launches"] for b in batches])


def rank_log(rank, *a):
    log(f"{time.strftime('%H:%M:%S')} rank {rank}:", *a)


def timed_alone(mesh, fn, reps):
    """fn's ms (wall_ms on this rank's card) on rank 0 while the other
    ranks wait, broadcast to every rank: the single-card yardstick, with
    the card to itself when ranks share one."""
    import torch.distributed as dist
    dist.barrier()
    ms = wall_ms(fn, [mesh.local], reps) if mesh.rank == 0 else None
    dist.barrier()
    return mesh.broadcast(ms)


def timed_together(mesh, fn, reps):
    import torch.distributed as dist
    dist.barrier()
    return wall_ms(fn, [mesh.local], reps)


def rank_msm(mesh, work, out):
    """sharded_msm over the ranks on phase 2's 2^18 G1 points against the
    closed form, with and without a blind, timed beside rank 0's
    single-card MSM."""
    from blockmaze_tpu_torch.curves import host_curve as HC
    from blockmaze_tpu_torch.curves import tcurve as tc
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.fields.constants import R_MOD
    from blockmaze_tpu_torch.msm import pippenger as pp
    from blockmaze_tpu_torch.parallel import mesh as pm
    dev, k, n = mesh.local, mesh.size, 1 << 18
    with np.load(os.path.join(work, "points.npz")) as z:
        pts = tuple(torch.from_numpy(z[f"arr_{i}"]).to(dev)
                    for i in range(3))
    py = random.Random(SEED)
    ks = [py.randrange(R_MOD) for _ in range(n)]
    sc = tf.to_tensor(tf.ints_to_limbs(ks), dev)
    want = HC.g1_mul(HC.g1_generator(),
                     sum((i + 1) * ki for i, ki in enumerate(ks)) % R_MOD)
    c = pp.default_window(n)
    shards = mesh.shard_points(pts)
    rows = []
    for blinded in (False, True):
        R, blind = ((pp.make_blind("g1", dev,
                                   mesh.broadcast(pp.blind_scalar())))
                    if blinded else (None, None))
        t1 = timed_alone(mesh, lambda: pp.msm("g1", pts, sc, c,
                                              pp.MAX_LANES, blind=blind), 3)

        def run():
            return pm.sharded_msm(mesh, "g1", shards, sc, c, pp.MAX_LANES,
                                  blind=blind)

        res = run()
        got = tc.g1_jacobian_to_host(tuple(v[None] for v in res[:3]))[0]
        if blinded:
            got = pp.unblind_msm("g1", got, res[3].cpu().numpy(), R, c)
        if got != want:
            raise AssertionError(f"sharded_msm over {k} ranks != closed "
                                 f"form")
        ms = timed_together(mesh, run, 3)
        row = {"blinded": blinded, "single_ms": round(t1, 3),
               "ms": round(ms, 3), "mpoints_s": round(n / ms / 1e3, 2),
               "efficiency": round(t1 / (k * ms), 3)}
        rank_log(mesh.rank, f"sharded_msm G1 2^18 c={c} over {k} ranks "
                 f"equals (sum i*k_i)*G: True; {json.dumps(row)}")
        rows.append(row)
    out["msm"] = rows


def rank_fft(mesh, out):
    """The sharded FFT, inverse, coset FFT and inverse coset FFT (std) over
    the ranks at basic 2^20 and mint's step domain, each equal to tntt's
    on this rank's card, timed beside rank 0's single-card one."""
    from blockmaze_tpu_torch.ntt import domain as TD
    from blockmaze_tpu_torch.ntt import tntt
    from blockmaze_tpu_torch.parallel import sntt
    rng = np.random.default_rng(SEED + 8)
    rows = []
    for d in (TD.get_evaluation_domain(1 << 20),
              TD.get_evaluation_domain((1 << 17) + (1 << 16))):
        dev = mesh.local
        T1 = tntt.tables_to({**tntt.qap_tables(d), **tntt.std_tables(d)},
                            dev)
        TS = sntt.tables_to(sntt.sqap_tables(d, mesh.size), mesh)
        a = rand_field(rng, (d.m,), dev)
        for op, one, sharded in (
                ("fft", lambda: tntt.fft_t(d, a, T1),
                 lambda: sntt.s_fft_t(mesh, d, a, TS)),
                ("ifft", lambda: tntt.ifft_t(d, a, T1),
                 lambda: sntt.s_ifft_t(mesh, d, a, TS)),
                ("coset_fft", lambda: tntt.coset_fft_t(d, a, T1),
                 lambda: sntt.s_coset_fft_t(mesh, d, a, TS)),
                ("icoset_fft std", lambda: tntt.icoset_fft_t(d, a, T1, True),
                 lambda: sntt.s_icoset_fft_t(mesh, d, a, TS, True))):
            label = f"m={d.m} {domain_kind(d)} {op}"
            if not torch.equal(one(), sharded()):
                raise AssertionError(f"sharded {label} over the ranks != "
                                     f"single card")
            ms1 = timed_alone(mesh, one, 10)
            msn = timed_together(mesh, sharded, 10)
            rank_log(mesh.rank, f"sharded {label} equal to single card: "
                     f"True; single {ms1:.4f} ms, {mesh.size} ranks "
                     f"{msn:.4f} ms")
            rows.append({"op": label, "single_ms": round(ms1, 4),
                         "ranks_ms": round(msn, 4)})
    out["fft"] = rows


def rank_prove(name, mesh, work):
    """Prover(mesh=global_mesh()) over circuit `name`'s cached keys: two
    proofs at (1, 2) equal to the parent's single-card proof, one at
    random (r, s), verified; the launches per proof against
    process_mesh_path; the Prover's device memory."""
    import torch.distributed as dist
    from blockmaze_tpu_torch.groth16 import generator, verifier
    from blockmaze_tpu_torch.groth16 import keys as K
    from blockmaze_tpu_torch.groth16.prover import Prover
    from blockmaze_tpu_torch.parallel import distributed
    from blockmaze_tpu_torch.serialization import libsnark_io as io
    from blockmaze_tpu_torch.utils import kernels as kn
    npz, vk_path = generator.cache_paths(name, SEED, KEY_CACHE)
    dpk = K.load_device_pk(npz)
    vk = io.load_verification_key(vk_path)
    with open(os.path.join(work, f"{name}.pkl"), "rb") as f:
        primary, aux, want = pickle.load(f)
    dev = mesh.local
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    prover = Prover(dpk, mesh=distributed.global_mesh())
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    mem = prover_memory(dev, before)
    kind = domain_kind(prover.domain)
    rank_log(mesh.rank, f"{name}: Prover {init_s:.2f}s (sharded QAP: "
             f"{prover.sharded_qap}; points nA/k={prover.nA // mesh.size}, "
             f"nH/k={prover.nH // mesh.size}); memory {json.dumps(mem)}")
    proofs, times = [], []
    dist.barrier()
    kn.reset_counts()
    for i, (r, s) in enumerate(((1, 2), (1, 2), (None, None))):
        t0 = time.perf_counter()
        proofs.append(prover.prove(primary, aux, r=r, s=s))
        dt = time.perf_counter() - t0
        times.append({"s": round(dt, 4),
                      **{k: round(v, 4) for k, v in prover.timings.items()}})
        rank_log(mesh.rank, f"{name} prove {i}: {json.dumps(times[-1])}")
    torch.cuda.synchronize(dev)
    counts = kn.counts()
    check_prove_counts(kind, counts, len(proofs),
                       process_mesh_path(mesh.size))
    for i in (0, 1):
        if (proofs[i].a, proofs[i].b, proofs[i].c) != tuple(want):
            raise AssertionError(f"{name} process mesh proof {i} != "
                                 f"single-card proof at (1, 2)")
    if not verifier.verify(vk, primary, proofs[2]):
        raise AssertionError(f"{name} process mesh random proof rejected")
    rank_log(mesh.rank, f"{name}: proofs 0 and 1 equal the single-card "
             f"proof at (1, 2); the random one verified")
    out = {"domain": kind, "init_s": round(init_s, 3), "mem": mem,
           "proofs": times, "launches": counts,
           "random_proof": [str(v) for v in (proofs[2].a, proofs[2].b,
                                             proofs[2].c)]}
    if name == BATCH_CIRCUIT:
        out["batch"] = rank_batch(prover, vk, mesh, work)
    del prover
    torch.cuda.empty_cache()
    return out


def rank_batch(prover, vk, mesh, work):
    """prove_batch on the process-mesh Prover of the parent's batch
    witnesses at BATCH_RS: each proof equal to the parent's single-card
    proof at its (r, s) and verified, the launches per proof against
    process_mesh_path."""
    import torch.distributed as dist
    from blockmaze_tpu_torch.groth16 import verifier
    from blockmaze_tpu_torch.utils import kernels as kn
    with open(os.path.join(work, "batch.pkl"), "rb") as f:
        insts, want = pickle.load(f)
    rs, ss = zip(*BATCH_RS[:len(insts)])
    dist.barrier()
    kn.reset_counts()
    t0 = time.perf_counter()
    proofs = prover.prove_batch(insts, rs=list(rs), ss=list(ss))
    dt = time.perf_counter() - t0
    torch.cuda.synchronize(mesh.local)
    counts = kn.counts()
    prover.close()
    check_prove_counts(domain_kind(prover.domain), counts, len(insts),
                       process_mesh_path(mesh.size))
    for i, (proof, w) in enumerate(zip(proofs, want)):
        if (proof.a, proof.b, proof.c) != tuple(w):
            raise AssertionError(f"process mesh batch proof {i} != the "
                                 f"single-card proof at {BATCH_RS[i]}")
        if not verifier.verify(vk, insts[i][0], proof):
            raise AssertionError(f"process mesh batch proof {i} rejected")
    rank_log(mesh.rank, f"prove_batch of {len(insts)} {BATCH_CIRCUIT} "
             f"witnesses at {BATCH_RS[:len(insts)]}: {dt:.3f}s, each equal "
             f"to the single-card proof and verified")
    return {"s": round(dt, 3), "launches": counts}


def process_mesh_rank(work, device):
    """One rank of phase 8: join the group on `device`, run every check on
    global_mesh() and write <work>/rank<i>.json."""
    require_gpu()
    import torch.distributed as dist
    from blockmaze_tpu_torch.parallel import distributed
    from blockmaze_tpu_torch.utils import kernels as kn
    t0 = time.perf_counter()
    if not distributed.initialize(device=device):
        raise RuntimeError("process mesh rank: no group to join")
    mesh = distributed.global_mesh()
    kn.kernel_lib()
    rank_log(mesh.rank, f"{mesh!r}, backend {mesh.backend}, this rank on "
             f"{mesh.local} ({torch.cuda.get_device_name(mesh.local)}); "
             f"joined in {time.perf_counter() - t0:.1f}s")
    out = {"rank": mesh.rank, "backend": mesh.backend,
           "devices": [str(d) for d in mesh.devices]}
    rank_msm(mesh, work, out)
    rank_fft(mesh, out)
    for name in MESH_CIRCUITS:
        out[name] = rank_prove(name, mesh, work)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    with open(os.path.join(work, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Phase 10: the port's drivers (blockmaze_tpu_torch/scripts)
# ---------------------------------------------------------------------------

def driver_runs(work):
    """(label, driver, its arguments, the kernels its path must launch,
    rank devices or None) of each run of phase 10: msmbench's phase split
    at 2^19 G1 and 2^18 G2, warmstart, e2e, batch and prewarm on mint
    (phases 3-4 prove the other circuits; phase 5 runs lifecycle's
    run_lifecycle), the bench over its four circuits on the seeded keys
    and over TEXT_KEY_CIRCUITS on phase 9's text keys (bench_key_dir in
    `work`), and scaling on a process mesh of 2 ranks (one a card over
    nccl with two or more cards, else both on cuda:0 over gloo) and, with
    four cards, of 4."""
    from blockmaze_tpu_torch.scripts import bench
    prove = PROVE_PATH["step"]["launch"]
    runs = [(f"msmbench {curve}", "msmbench",
             ["--phases", "--n", str(log_n), "--curve", curve, "--window",
              str(MSMBENCH_WINDOW)], MSM_KERNELS, None)
            for curve, log_n in MSMBENCH_RUNS]
    runs += [("warmstart", "warmstart", ["mint"], prove, None),
            ("e2e", "e2e", ["mint"], prove, None),
            ("batch", "batch", ["--circuit", "mint", "--batch", "8"], prove,
             None),
            ("prewarm", "prewarm", ["--circuits", "mint"], prove, None),
            ("bench", "bench", [], prove, None),
            ("bench text keys", "bench",
             [c for c in bench.CIRCUITS if c in TEXT_KEY_CIRCUITS]
             + ["--key-dir", bench_key_dir(work)], prove + DECOMPRESS,
             None)]
    return runs + scaling_runs()


def bench_key_dir(work) -> str:
    """A directory laid out as bench.py's reference_harness/prfKey/: for
    each of TEXT_KEY_CIRCUITS, <circ>pk.txt linked to phase 9's text key
    and <circ>vk.txt to the seeded vk; the bench writes the npz of its
    load beside them."""
    from blockmaze_tpu_torch.groth16 import generator
    d = os.path.join(work, "bench_keys")
    os.makedirs(d)
    for c in TEXT_KEY_CIRCUITS:
        os.symlink(os.path.join(KEY_CACHE, "text", f"{c}_s{SEED}.txt"),
                   os.path.join(d, f"{c}pk.txt"))
        os.symlink(generator.cache_paths(c, SEED, KEY_CACHE)[1],
                   os.path.join(d, f"{c}vk.txt"))
    return d


def scaling_runs():
    cards = torch.cuda.device_count()
    meshes = ([[f"cuda:{i}" for i in range(k)] for k in (2, 4) if k <= cards]
              if cards >= 2 else [["cuda:0", "cuda:0"]])
    return [(f"scaling {len(d)} ranks", "scaling", [], MSM_KERNELS, d)
            for d in meshes]


def run_driver(label, name, args, devices, work):
    """`python -m blockmaze_tpu_torch.scripts.<name> args` from the repo
    root, as one process, or with `devices` as one process a device
    joined by --coordinator/--num-processes/--process-id (rank 0
    prints). Its output is printed with a [label] prefix; it must exit 0,
    print its OK line and end with a JSON line, returned with the
    seconds."""
    cmd = [sys.executable, "-m", f"blockmaze_tpu_torch.scripts.{name}",
           *args]
    tag = label.replace(" ", "_")
    if devices is None:
        cmds, logs = [cmd], [os.path.join(work, f"{tag}.log")]
    else:
        port = free_port()
        k = len(devices)
        # one card a rank: --device cuda, the rank's card from the
        # hostnames; ranks sharing cuda:0 name it
        dev = "cuda:0" if len(set(devices)) < k else "cuda"
        cmds = [cmd + ["--coordinator", f"127.0.0.1:{port}",
                       "--num-processes", str(k), "--process-id", str(r),
                       "--device", dev] for r in range(k)]
        logs = [os.path.join(work, f"{tag}.rank{r}.log") for r in range(k)]
    t0 = time.perf_counter()
    rcs = run_procs(cmds, [{}] * len(cmds), logs, DRIVER_TIMEOUT)
    dt = time.perf_counter() - t0
    lines = []
    for r, path in enumerate(logs):
        with open(path) as f:
            mine = [line.rstrip() for line in f]
        for line in mine:
            log(f"  [{label}{'' if devices is None else f' rank {r}'}] "
                f"{line}")
        lines = lines or mine
    if any(rc != 0 for rc in rcs):
        raise RuntimeError(f"{label}: exited {rcs}")
    if not any(line.startswith(DRIVER_OK[name]) for line in lines):
        raise RuntimeError(f"{label}: no {DRIVER_OK[name]!r} line")
    return json.loads(lines[-1]), dt


def msmbench_parity(dev, report):
    """The MSM kernels at msmbench's shapes (MSMBENCH_RUNS), on its own
    inputs (msmbench.inputs: its points, scalars and blind), blinded as it
    runs them: each against its plain version at pippenger.MAX_LANES
    lanes (stream_parity); the times go on the kernels line under
    "shapes"."""
    from blockmaze_tpu_torch.msm import pippenger as pp
    from blockmaze_tpu_torch.scripts import msmbench
    c = MSMBENCH_WINDOW
    for curve, log_n in MSMBENCH_RUNS:
        tag = f"msmbench {curve} 2^{log_n} c={c}"
        pts, _, sc, (_, blind) = msmbench.inputs(1 << log_n, curve, dev)
        stream_parity(curve, pts, pp.live_stream(pts, sc, c), blind, c, tag,
                      check_kernel, functools.partial(record_kernel, report,
                                                      tag=tag))
        del pts, sc
        torch.cuda.empty_cache()


def phase10(mesh_only: bool, dev, report):
    """The port's drivers, each its own process after phases 3-4 (and 8)
    left _build/ and _keys/ warm (docstring, phase 10), msmbench's after
    its MSM kernels were held against their plain versions at its shapes
    (msmbench_parity). Returns their paths' launches (each driver resets
    the counts before its measured work and reports them in its JSON
    line)."""
    if not mesh_only:
        msmbench_parity(dev, report)
    summary, path_counts = {}, []
    with tempfile.TemporaryDirectory(prefix="bm_drivers_") as work:
        runs = scaling_runs() if mesh_only else driver_runs(work)
        for label, name, args, kernels, devices in runs:
            out, dt = run_driver(label, name, args, devices, work)
            check_launches(f"{label} path", out["launches"], kernels)
            path_counts.append(out["launches"])
            log(f"  {label}: {dt:.1f}s, exit 0, its OK line and JSON line")
            summary[label] = driver_numbers(name, out, devices)
    log(f"  drivers summary: {json.dumps(summary)}")
    return path_counts


def driver_numbers(name, out, devices):
    """What the drivers summary keeps of a driver's JSON line; checks the
    results it reports."""
    if name == "msmbench":
        if not out["closed_form"]:
            raise AssertionError("msmbench: not its closed form")
        return {k: out[k] for k in ("best_ms", "mpoints_per_s", "phases_ms",
                                    "phases_sum_ms")}
    if name == "warmstart":
        return {"laps_s": out["laps_s"], "library": out["library"]}
    if name == "e2e":
        return [{k: r[k] for k in ("circuit", "first_s", "verified",
                                   "oracle")} for r in out["circuits"]]
    if name == "batch":
        return {k: out[k] for k in ("single_s", "batch_s", "s_per_proof",
                                    "proofs_per_s", "B_x_single_s")}
    if name == "prewarm":
        return out["circuits"]
    if name == "bench":
        return bench_numbers(out)
    backend = "gloo" if len(set(devices)) < len(devices) else "nccl"
    if not out["equal"] or out["backend"] != backend or \
            out["processes"] != len(devices):
        raise AssertionError(f"scaling on {devices}: {out}")
    return {k: out[k] for k in ("backend", "placement", "points", "rows")}


def bench_numbers(out):
    """What the drivers summary keeps of a bench run: each circuit's
    proofs/s, proof, witness, first-prove, Prover and key seconds and key
    source; raises unless it benched every circuit it was given (the text
    keys: TEXT_KEY_CIRCUITS, else all four) from the keys it was
    given, every proof verified, and each circuit's proofs launched
    PROVE_PATH's kernels for its domain kind."""
    from blockmaze_tpu_torch.scripts import bench
    text = out["key_dir"] is not None
    circuits = [c for c in bench.CIRCUITS
                if not text or c in TEXT_KEY_CIRCUITS]
    source = "key dir" if text else "seeded cache"
    if out.get("errors") or out["backend"] != "cuda":
        raise AssertionError(f"bench: {out.get('errors')}, backend "
                             f"{out['backend']}")
    res = {k: out[k] for k in ("library", "build_sec", "metric", "value",
                               "value_e2e", "vs_baseline")}
    for c in circuits:
        if not out[f"{c}_verified"] or out[f"{c}_key_source"] != source:
            raise AssertionError(f"bench {c}: verified "
                                 f"{out[f'{c}_verified']}, key source "
                                 f"{out[f'{c}_key_source']}, not {source}")
        check_prove_counts(out[f"{c}_domain"], out[f"{c}_launches"],
                           1 + out["reps"])
        res[c] = {k: out[f"{c}_{k}"] for k in (
            "proofs_per_sec", "proofs_per_sec_with_witness", "prove_secs",
            "first_prove_sec", "witness_sec", "warmup_sec", "key_sec",
            "key_source", "lanes", "window", "vs_baseline")}
    return res


if __name__ == "__main__":
    if sys.argv[1:2] == [RANK_FLAG]:
        process_mesh_rank(*sys.argv[2:4])
    else:
        main()
