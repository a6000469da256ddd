#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; so does a missing card):
  1. environment — the card's name and power limit; TF32 off for matmul
     and cuDNN.
  2. build — every kernel under src/repro_torch/csrc with nvcc (sm_90a).
  3. kernels — each kernel against its plain PyTorch version at the main
     path's full-width shapes, with times of kernel, plain version and a
     PyTorch library call (CUDA events over back-to-back calls, and the
     device time from a torch.profiler window, also of the plain version:
     the op chain a fused kernel replaces), and the least time the card
     could take. Paged attention: the whole op with the write log (two
     launches), and the pages alone; flash attention (bf16, tensor-core
     route) at S=381 and S=517; the KV append as the decode step runs it
     (the K/V epilogue fused in: bias, qk-norm, RoPE, append), and alone;
     log compaction into both tiers in one launch, and into one pool. Once
     at qwen3-1.7b's shapes (GQA group of 2) and once at olmoe-1b-7b's
     (16 KV heads of 16 query heads: a group of 1); flash attention also at
     phase 6's shapes (whisper's encoder and cross-attention, non-causal;
     zamba2's shared block at head dim 112), at the train shapes of phases
     7 and 9, at a phase 10 rank's prefill, (4, 381, 8, 128) / KV 4, and
     at phase 11's per-rank shapes (whisper's encoder, self- and
     cross-attention at 4 heads of 64, zamba2's shared block at 16 of 112,
     in its prefill and its train step). The MoE's routing glue (route,
     slots, dispatch, SwiGLU epilogue, combine) at olmoe-1b-7b's widths and
     a decode step's 32 rows and prefills of 768 and 2048: its routing
     decisions bit-equal to the plain version's, each kernel and a whole
     moe_ffn call timed against the plain version, and the call's device
     ops at decode counted (9 at most).
  4. serving — full-width qwen3-1.7b (random weights from a seed) through
     the port's TieredEngine: every kernel launched as often as the
     deterministic policy requires, every flash call on the tensor-core
     route, ServeStats equal to the reduced-width run on the CPU, every
     emitted token within a near-tie tolerance of the maximum of the dense
     decode's teacher-forced logits; tokens/s of the tiered and the dense
     (baseline) serving loops; then a profiled window of decode steps
     (device busy time and idle share).
  5. serving, MoE — full-width olmoe-1b-7b (64 experts, top 8, capacity
     bounded) through the same engine, prompts and KV config, checked as in
     phase 4 except the token reference: a capacity MoE routes each row by
     the rows beside it, so the reference replays the engine's own batches
     over dense KV caches (``launch/serve.py::replay_dense``), with the
     tokens forced (printed), then with the run's routing forced too
     (checked: token gaps, and how far each routed expert lies below the
     replay router's own k-th logit); the exact-match rate against a
     batch-1 dense decode is printed for information. The profiled window
     adds the MoE's share of the device time by phase: the device ops
     whose launch falls inside each phase's host range.
  6. serving, other families — full-width whisper-base, rwkv6-3b and
     zamba2-7b (random weights from the seed) through the step builders
     (``launch/steps.py``: prefill, then greedy decode), as JAX serves
     them: 4 prompts of 381 tokens (whisper: frames (4, 103, 512) from the
     seed, so the cross cache needs no padding) and 32 tokens each. Checks:
     the prefill's flash launches exact (whisper 18: 6 encoder + 6 self + 6
     cross; zamba2 13, at head dim 112; rwkv6 0), all on the tensor-core
     route; the family's invariant, decode (the one-token recurrence) equal
     to the teacher-forced forward (the chunked scan) on the run's tokens,
     in fp32 on the same weights within SCAN_TOL; the teacher-forced bf16
     decode reproduces the served tokens, and each served token lies within
     max(NEAR_TIE, 2 x the bf16 noise measured against fp32) of the bf16
     forward's maximum (random full-width weights amplify bf16 rounding to
     O(1) logits: ROADMAP.md §3). Prints tok/s, a profiled window of 4
     decode steps (device busy, device ops, idle share) and the decode floor
     (bytes a step must move at 3.35 TB/s).
  7. training — (a) flash attention's backward (the autograd wrapper's
     ``flash_attention_bwd``, PyTorch ops) at qwen3-1.7b's train shape
     (1, 4096, 16, 128) / KV 8 causal and at phase 6's shapes: the output
     against the plain version, and dq, dk, dv against its autograd on the
     card (TOL's allclose and TOL_BWD_REL of each tensor's max), with the
     backward's device time, the plain version's, sdpa's backward (the
     library yardstick, measured only) and a bound. Phase 3 times the
     forward at the train shape. (b) full-width qwen3-1.7b (2.03 B params)
     trained through ``launch/steps.py::build_train_step`` on the launcher's
     ``SyntheticLM`` data: seq 4096, global batch 4, 4 microbatches, remat;
     one step with int8 error-feedback compression and the others without.
     Checks: the first step's wq, wk, wv gradients within TRAIN_LEAF_TOL of
     each leaf's max, and its loss and grad norm within TRAIN_LOSS_RTOL /
     TRAIN_GNORM_RTOL, of the same step with ``flash_attention_ref`` patched
     in (same weights, same batch); flash launches exactly 224 a step (28
     layers x (forward + remat recompute) x 4 microbatches), all on the
     tensor-core route; every loss finite and the last below the first;
     params equal to bf16(master) bit for bit after every step. Prints step
     ms, tokens/s, peak memory, the model-FLOP share and a profiled step's
     device busy and idle share.
  8. distribution — a one-rank NCCL process group (a free local port) and
     ``launch/mesh.py::make_host_mesh("cuda")``, a 1 x 1 data x model mesh.
     The state of phase 7, drawn again from its seed, is placed on the mesh
     by ``launch/steps.py::shard_train_state``: the card's allocation grows
     by the dry run's per-device state bytes with the residual
     (``launch/dryrun.py::cell_bytes`` on 1 x 1) within DRYRUN_MEM_RTOL.
     ``build_train_step(mesh=)``, the sharded step (one gather of the
     params, this rank's rows, the fp32 gradient summed over the data
     ranks, whole-leaf int8 scale and a norm that counts each element once),
     runs phase 7's step 0: its loss, grad norm and every updated bf16
     parameter equal phase 7's bit for bit; then one more step, timed. Flash
     launches exactly 224 a step, all tensor-core. Prints both steps' times,
     the peak memory and the dry run's bytes beside the card's.
  9. split training — the split train step (``build_train_step(mesh=)``
     for the dense family: per-layer FSDP gathers, Megatron TP over "model"
     for heads, ffn and vocab) on a (data 1, model 2) mesh: two processes
     on the one card (``torch.multiprocessing`` spawn) over gloo with CUDA
     tensors, since NCCL refuses two ranks on one device. Phase 7's state,
     drawn again from its seed, placed by ``shard_train_state``: each rank's
     allocation grows by the dry run's per-device state bytes with the
     residual on (1, 2) within DRYRUN_MEM_RTOL. Phase 7's step 0 without
     compression, then one step with it: step 0's loss and grad norm within
     SPLIT_LOSS_RTOL / SPLIT_GNORM_RTOL of phase 7's step 0; each rank's
     shard of each leaf's mu within SPLIT_MU_TOL (gains and biases
     SPLIT_MU_TOL_SUMS) of the leaf's max in phase 7's; every updated bf16
     parameter whose mu agrees in sign with phase 7's (both above
     SPLIT_MU_FLOOR) within SPLIT_ULPS of its ulps of phase 7's, and the
     count of differing elements printed (phase 7's params and mu shared
     with the ranks through CUDA IPC; each element counted once); flash
     launches 224 a step on each rank, all tensor-core, at (1, 4096, 8,
     128) / KV 4; each rank's peak below phase 8's; the compressed step's
     loss finite. Prints each rank's step ms: gloo stages every collective
     through the host, so these time host staging, not TP over NVLink.
     Rank 0's step 0 runs under the profiler: its kernels' busy ms beside
     the step's.
 10. sharded serving — full-width qwen3-1.7b (random weights from the seed)
     served with phase 6's prompts (4 of 381 tokens, 32 new) through the
     sharded prefill and decode steps (``launch/steps.py``
     ``build_prefill_step(mesh=)`` / ``build_serve_step(mesh=)``, params by
     ``sharding.shard_params``, the decode cache by ``decode_cache(mesh=)``
     at max_len SERVE_MAX_LEN: the sequence split over "model", every KV
     head whole on each rank, decode attention combined over the chunks).
     (a) The reference: the unsharded steps on the card. (c) A 1 x 1 mesh
     over a one-rank NCCL group: the reference's tokens and every step's
     logits bit for bit, the prefill's 28 flash launches on the tensor-core
     route. (b) A (data 1, model 2) mesh: two processes on the one card over
     gloo with CUDA tensors (as phase 9). Checks: each served token within
     NEAR_TIE of the reference's max logit on the same prefix (the
     unsharded steps teacher-forced on the run's tokens; the largest gap
     printed); each rank's cache allocation equal to the dry run's
     (``dryrun.cache_bytes`` under ``cache_pspec``) within DRYRUN_MEM_RTOL,
     its local shape half the sequence (a replicated cache would pass
     silently otherwise); 28 flash launches a rank in the prefill, all
     tensor-core, at (4, 381, 8, 128) / KV 4; both ranks' tokens equal.
     Prints each rank's peak, prefill ms, decode-step ms and tok/s with no
     limit: gloo's host staging, not NVLink.
 11. split families — full-width whisper-base, rwkv6-3b and zamba2-7b
     (random weights from the seed) through the split steps: serving at
     full depth with phase 6's prompts (and whisper's frames), FAMILY_SPLIT_NEW
     tokens each, the cache at SERVE_MAX_LEN; one train step at seq 4096
     with the config's train_4k microbatch rows (FAMILY_TRAIN_ACCUM
     microbatches) at full width and FAMILY_TRAIN_LAYERS' depth (printed
     beside the depth the dry run would allow on one card). (a) The
     unsharded steps on the card. (c) 1 x 1 over a one-rank NCCL group:
     tokens, every step's logits, step 0's metrics and every updated
     parameter bit-equal to (a); flash launches exact, tensor-core. (b)
     (data 1, model 2), two ranks on the card over gloo (as phase 9): each
     served token within phase 6's max(NEAR_TIE, 2 x bf16 noise) of (a)'s
     teacher-forced max logit on its prefix; each rank's cache entries
     ``cache_pspec``'s local shapes, its allocation within
     FAMILY_CACHE_RTOL of the dry run's ``cache_bytes``, and its train
     state's within DRYRUN_MEM_RTOL of the dry run's; flash launches a rank
     exact (the prefill's at the rank's heads, none in decode; the train
     step's as (a)'s), all tensor-core; step 0's loss and grad norm within
     SPLIT_LOSS_RTOL / SPLIT_GNORM_RTOL of (a)'s, each leaf's mu within
     SPLIT_MU_TOL (gains, biases and rwkv6's leaves SPLIT_MU_TOL_SUMS) of
     its max. Prints prefill, decode and step ms, tok/s, peaks and each
     rank's idle share (profiled decode steps and train step) with no
     limit, and the phase's seconds by arch.
 12. layout profiles — JAX's "dp" and "tp_only" layouts
     (``sharding.layout_rules``; ``layout=`` of the step builders). First
     flash attention at full-width smollm-135m's train shapes (9 heads over
     3 KV heads, hd 64, seq 4096: the whole microbatch of 8 rows and a "dp"
     rank's 4), forward against the plain version and timed beside sdpa as
     in phase 3, backward as in 7a, in a spawned process (after phases 8–11
     the main process's profiler records no device op). (a) Full-width,
     full-depth smollm-135m
     (random weights from the seed) trained one step through the unsharded
     step at seq 4096: LAYOUT_ROWS rows, the config's train_4k microbatch of
     8, so LAYOUT_ACCUM microbatches. (c) "dp" on 1 x 1 over a one-rank NCCL
     group: step 0's metrics and every updated param bit-equal to (a). (b)
     "dp" on (data 1, model 2), two ranks on the card over gloo (as phase
     9), each a replica computing its 4 rows of each microbatch: step 0's
     loss and grad norm within SPLIT_LOSS_RTOL / SPLIT_GNORM_RTOL of (a)'s,
     or twice (a)'s own distance from the same gradient in fp32 where that
     is larger (phase 11's rule: the tied embedding's bf16 gradient at
     full width is mostly rounding);
     both ranks' updated params bit-equal; no TP collective (no all-gather,
     and every all-reduce a leaf's bf16 gradient or the fp32 loss and clip
     norm); each rank's state allocation within DRYRUN_MEM_RTOL of the "dp"
     dry run's on (1, 2); flash launches exact on each rank, all
     tensor-core, at (4, 4096, 9, 64) / KV 3. (d) In the same ranks,
     whisper-base served under "dp" on (1, 2) and qwen3-1.7b under
     "tp_only" on (data 2, model 1), each rank 2 of phase 6's 4 prompts
     (FAMILY_NEW tokens each): every served token within NEAR_TIE of the
     unsharded steps' teacher-forced max logit (the count equal to the
     unsharded steps' tokens printed); prefill flash launches exact,
     tensor-core; under "tp_only" no weight bytes gathered over "data".
     Prints step, prefill and decode ms and the phase's seconds.

The line before the last is the card as nvidia-smi names it, the one
before that a JSON object with one entry per kernel, and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12  # fp32 outside the tensor cores

SEED = 0
PROMPT_LENS = [203, 251, 298, 339, 387, 429, 466, 517]  # none a multiple of 16
NEW_TOKENS = 48
# the serving runs' launches: the policy depends on lengths only (128
# steps, 8 prefills, 7 compactions), so a call a layer gives the counts
# (moe_routing: five launches a MoE layer, each step and each prefill;
# mamba_step, rms_norm_rows and ssd_scan: the "zamba2" family's only)
EXPECTED_LAUNCHES = {
    "qwen3-1.7b": {"paged_attention": 3584, "log_compact": 7, "kv_log_append": 3584, "flash_attention": 224,
                   "moe_routing": 0, "mamba_step": 0, "rms_norm_rows": 0, "ssd_scan": 0},
    "olmoe-1b-7b": {"paged_attention": 2048, "log_compact": 7, "kv_log_append": 2048, "flash_attention": 128,
                    "moe_routing": 10880, "mamba_step": 0, "rms_norm_rows": 0, "ssd_scan": 0},
}
SERVING_KERNELS = ("paged_attention", "log_compact", "kv_log_append", "flash_attention")
# phase 6: the families JAX serves through its step builders
FAMILY_ARCHS = ("whisper-base", "rwkv6-3b", "zamba2-7b")
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW = 4, 381, 32  # 381: the chunked scans pad
FAMILY_FLASH = {"whisper-base": 18, "rwkv6-3b": 0, "zamba2-7b": 13}  # prefill launches
# flash attention at phase 6's shapes: (name, B, S, S_kv, H, KV, hd, causal)
FLASH_FAMILY_SHAPES = (
    ("whisper-base encoder", 4, 103, 103, 8, 8, 64, False),
    ("whisper-base cross-attention", 4, 381, 103, 8, 8, 64, False),
    ("zamba2-7b shared block", 4, 381, 381, 32, 32, 112, True),
)
# phase 6b: Zamba2-7B-Instruct through TieredEngine at its benchmark cell's
# settings (bench/cells/zamba2-7b-instruct.batch.json): one full batch of
# ZAMBA2_BATCH prompts (256-2048 tokens), then ZAMBA2_STEPS decode steps
# while the prompts' pages are promoted from the host tier (32 a step), two
# log compactions' worth and more
ZAMBA2_ARCH = "zamba2-7b-instruct"
ZAMBA2_BATCH, ZAMBA2_STEPS, ZAMBA2_NEW = 16, 40, 64
ZAMBA2_PROMPTS = (337, 1203, 768, 2048, 512, 903, 256, 640, 1500, 412, 768, 1024, 300, 860, 590, 1100)
ZAMBA2_KV = dict(page_size=16, n_hbm_pages=2304, max_pages_per_req=160, log_slots=192, promote_pages_per_step=32)
ZAMBA2_CHECKED = 4  # requests held against the plain float32 reference (models/zamba2_ref.py)
ZAMBA2_GAP_MEAN = 0.06  # the cell's gap limit (PERF.md section 6, the table of gap limits)
# a step's launches: a Mamba layer's mamba_step and row norm; a site's append,
# paged call and two row norms (the block's input and FFN norms); a prefill's:
# a site's flash call, the same norms
ZAMBA2_LAYERS, ZAMBA2_SITES = 81, 13
ZAMBA2_NORMS = ZAMBA2_LAYERS + 2 * ZAMBA2_SITES
# the kernels against their plain versions at the cell's shapes: mamba_step's
# SSM states relative, its conv windows exact, y (unit scale after the group
# norm) within one bf16 ulp at 1, relative and absolute: C.S + D x cancels
# to near 0 in some elements, where the sums' other order is several ulps of
# the small value (4 in the first chip run, at seed 0); the row norm in bf16
# ulps; flash and paged attention at TOL
TOL_MAMBA_STATE, TOL_MAMBA_Y, TOL_NORM_ULPS = 1e-6, 2.0 ** -7, 1
# the prefill scan (fp32 sums in another order than the plain version's),
# relative to |plain| + 1, for y and the final state
TOL_SSD_SCAN = 1e-4
# the fused K/V epilogue at hd 224 (RoPE only) in bf16 ulps
TOL_EPILOGUE_224_ULPS = 1
# phase 7: training
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = 4096, 4, 4
TRAIN_STEPS = 6  # step 1 compresses; then one more, profiled
# no warmup (a first update at lr 0 would test nothing); 1e-5 is the rate
# at which the random full-width model's loss falls step by step
# (scripts/train_lr_sweep.py on an H100: at 3e-5 and above, or 3e-4 after a
# warmup, it climbs for a few steps before it falls)
TRAIN_LR = 1e-5
TRAIN_FLASH_PER_STEP = 28 * 2 * TRAIN_ACCUM  # layers x (forward + remat recompute) x microbatches
TRAIN_PARTS = ("attention backward", "adamw")  # profiler ranges of the profiled step
# the plain-attention step differs from the kernel's by the kernel's bf16
# rounding of the softmax weights before P.V (forward and recompute): O by
# ~1 bf16 ulp here and there, under a mean over 16,384 tokens. About 10x
# the gaps measured on an H100 (loss 2.43e-5, grad norm 1.08e-5)
TRAIN_LOSS_RTOL = 2.5e-4
TRAIN_GNORM_RTOL = 1e-4
# the attention projections' step-0 gradients, kernel against plain
# attention, each leaf within this fraction of its max |value| (measured on
# an H100: wq 0.0054, wk 0.0054, wv 0.0029; a lost gradient through
# attention is off by 1)
TRAIN_ATTN_LEAVES = ("blocks.wq", "blocks.wk", "blocks.wv")
TRAIN_LEAF_TOL = 2e-2
# phase 8: the dry run's per-device state bytes against the card's
# allocation (the caching allocator rounds each block up to 512 bytes)
DRYRUN_MEM_RTOL = 5e-3
SHARDED_PATH = f"train sharded 1x1 {TRAIN_ARCH}"
# phase 9: the split step on (data 1, model 2), two ranks on the one card
SPLIT_MESH = (1, 2)
SPLIT_PATH = f"train split 1x2 {TRAIN_ARCH}"
SPLIT_TIMEOUT_S = 900  # a gloo collective that waits longer fails the rank
# step 0 against phase 7's: TP sums each block's partial products over the
# two ranks (in fp32), which moves bf16 activations by an ulp here and
# there. About 10x the largest gaps of the split step to the unsharded
# step in tests/test_torch_tensor_parallel.py at reduced width (loss
# 1.96e-6, grad norm 5.52e-4, measured on the CPU)
SPLIT_LOSS_RTOL = 2e-5
SPLIT_GNORM_RTOL = 5e-3
# mu after step 0 is (1 - b1) x the clipped gradient: each rank's shard of
# each leaf within these fractions of the whole leaf's max |value| in phase
# 7's (the CPU tests' tolerances: MU_TOL, and 5e-2 for the leaves with at
# most one axis besides "layers", the gains and biases, whose gradients sum
# bf16 products over every position). Phase 7's mu reaches the ranks in
# bf16, 2^-9 of each value at most. A sum over "model" left out leaves a
# leaf's mu off by about half its max.
SPLIT_MU_TOL, SPLIT_MU_TOL_SUMS = 2e-2, 5e-2
# AdamW's first step moves a master by lr x mu / (|mu| + eps'): where the
# two sides' mu agree in sign and both exceed SPLIT_MU_FLOOR (eps' under
# 1e-2 of |mu|), the two masters part by under 1e-2 lr, so each updated
# bf16 parameter there lies within SPLIT_ULPS of its ulps (a rounding on
# each side) + SPLIT_MASTER_ABS of phase 7's; the absolute term holds a
# parameter that ends near 0, whose ulps are tiny (measured on an H100: up
# to 24,611 ulps apart where mu agrees, within 0.352 of this allowance).
# Elsewhere the two may part by up to 2 lr: counted and printed, not held.
SPLIT_MU_FLOOR = 1e-7
SPLIT_ULPS = 2
SPLIT_MASTER_ABS = 1e-2 * TRAIN_LR
SPLIT_PEAK_LIMIT = 52.80e9  # phase 8's peak on one rank (measured on one H100)
# phase 10: sharded prefill and decode of qwen3-1.7b with phase 6's prompts
SERVE_ARCH = "qwen3-1.7b"
SERVE_MESH = (1, 2)
# 381 + 32 = 413 positions, rounded up to a multiple of the "model" size:
# filter_spec_for_mesh replicates a sequence the axis does not divide
SERVE_MAX_LEN = 416
SERVE_PATH = f"serve sharded 1x2 {SERVE_ARCH}"
SERVE_1X1_PATH = f"serve sharded 1x1 {SERVE_ARCH}"
SERVE_FLASH = 28  # prefill launches a rank: one a layer
# phase 11: the encdec, rwkv6 and mamba2 families split over (data 1, model
# 2) and 1 x 1: serving at full depth with phase 6's prompts and the cache
# at SERVE_MAX_LEN, FAMILY_SPLIT_NEW tokens a prompt (phase 6's 32 cut:
# gloo's collectives take ~1 ms each, and zamba2's decode step runs ~400),
# and one train step at train_4k's sequence with the config's microbatch
# rows (over FAMILY_TRAIN_ACCUM microbatches: whisper's 16 rows of fp32
# logits over its 51,865-word vocab, whole on each rank, would not fit two
# ranks at once), at full width and FAMILY_TRAIN_LAYERS' depth
FAMILY_SPLIT_MESH = (1, 2)
FAMILY_SPLIT_NEW = 8
FAMILY_TRAIN_ACCUM = {"whisper-base": 4, "rwkv6-3b": 2, "zamba2-7b": 2}
# the depth trained (None: full): the dry run would allow far more on one
# card (printed), but gloo stages each rank's collectives through the host
# at ~1-2 GB/s, so a layer costs seconds a step; zamba2 keeps two
# applications of its shared block (6 Mamba layers each)
FAMILY_TRAIN_LAYERS = {"whisper-base": None, "rwkv6-3b": 4, "zamba2-7b": 12}
# each rank's decode cache against the dry run's cache_bytes, the bytes
# requested from the allocator (``requested_bytes``; the dry run counts the
# int32 length too)
FAMILY_CACHE_RTOL = 1e-4
# step 0 against the unsharded step's: phase 9's limits (SPLIT_LOSS_RTOL,
# SPLIT_GNORM_RTOL, SPLIT_MU_TOL and SPLIT_MU_TOL_SUMS), or twice the
# unsharded bf16 step's own distance from the same step in fp32 where that
# is larger: random full-width weights make rwkv6's bf16 gradients mostly
# rounding (its unsharded bf16 gradient lies 4-64 % of a leaf's max from
# fp32 at 4 layers and seq 1024, scripts/rwkv6_bf16_grad_noise.py on the
# CPU; at seq 4096 on an H100 its grad norm is 37.1 in bf16 and 4,960 in
# fp32). The split's fp32 loss and gradients against the unsharded model's
# in fp32, of each leaf's max: the split changes the layout, not the
# function (a gradient counted twice is off by its leaf's max). rwkv6's
# fp32 gradient is itself ill-conditioned: the split lay 5.27e-3 from it on
# w0 at seq 4096 on an H100 (1.0e-4 at seq 1024 on the CPU; at reduced
# width its own fp32 gradient lies 1.4e-4 from fp64,
# tests/test_torch_tp_ops.py), so it is held to 2e-2
FAMILY_FP32_TOL = {"rwkv6-3b": 2e-2}
FAMILY_FP32_TOL_DEFAULT = 1e-3
# flash attention at phase 11's per-rank shapes: a rank's heads of phase 6's
# prefill and of its train step (whisper: 4 rows a microbatch, 1,024 frames;
# zamba2: 1 row)
FLASH_SPLIT_FAMILY_SHAPES = (
    ("whisper-base serve split 1x2 encoder, a rank's heads", 4, 103, 103, 4, 4, 64, False),
    ("whisper-base serve split 1x2 self-attention, a rank's heads", 4, 381, 381, 4, 4, 64, True),
    ("whisper-base serve split 1x2 cross-attention, a rank's heads", 4, 381, 103, 4, 4, 64, False),
    ("zamba2-7b serve split 1x2 shared block, a rank's heads", 4, 381, 381, 16, 16, 112, True),
)
FLASH_SPLIT_FAMILY_TRAIN_SHAPES = (
    ("whisper-base train split 1x2 self-attention, a rank's heads", 4, 4096, 4096, 4, 4, 64, True),
    ("whisper-base train split 1x2 cross-attention, a rank's heads", 4, 4096, 1024, 4, 4, 64, False),
    ("zamba2-7b train split 1x2 shared block, a rank's heads", 1, 4096, 4096, 16, 16, 112, True),
)
# phase 12: JAX's layout profiles. smollm-135m trained at seq TRAIN_SEQ
# with the config's train_4k microbatch (8 rows) over LAYOUT_ACCUM
# microbatches; "dp" on (data 1, model 2) gives each rank 4 rows of each
# microbatch
LAYOUT_ARCH = "smollm-135m"
LAYOUT_ROWS, LAYOUT_ACCUM = 16, 2
LAYOUT_MESH = (1, 2)
LAYOUT_FLASH_PER_STEP = 30 * 2 * LAYOUT_ACCUM  # layers x (forward + remat recompute) x microbatches
# (arch, layout, mesh) served in phase 12 (d), and their prefill's flash launches a rank
LAYOUT_SERVE = (("whisper-base", "dp", (1, 2)), ("qwen3-1.7b", "tp_only", (2, 1)))
LAYOUT_SERVE_FLASH = {"whisper-base": 18, "qwen3-1.7b": 28}
FLASH_LAYOUT_SHAPES = (
    ("smollm-135m train", 8, 4096, 4096, 9, 3, 64, True),
    ("smollm-135m train dp 1x2, a rank's rows", 4, 4096, 4096, 9, 3, 64, True),
)
# flash attention at the train shape (forward and backward), at a split
# rank's heads, and its backward at phase 6's shapes too
FLASH_TRAIN_SHAPE = ("qwen3-1.7b train", 1, 4096, 4096, 16, 8, 128, True)
FLASH_SPLIT_SHAPE = ("qwen3-1.7b train split 1x2, a rank's heads", 1, 4096, 4096, 8, 4, 128, True)
FLASH_BWD_SHAPES = (FLASH_TRAIN_SHAPE, FLASH_SPLIT_SHAPE) + FLASH_FAMILY_SHAPES + FLASH_SPLIT_FAMILY_TRAIN_SHAPES
# and the forward at a rank's heads in phase 10's prefill (serving has no backward)
FLASH_SERVE_SHAPE = ("qwen3-1.7b serve split 1x2, a rank's heads", 4, 381, 381, 8, 4, 128, True)
# the backward's dq, dk, dv: besides TOL's allclose, each tensor within this
# fraction of its max |value| (the CPU tests' bf16 bound)
TOL_BWD_REL = 1e-2
MOE_PHASES = ("moe_route", "moe_slots", "moe_dispatch", "moe_experts", "moe_combine")
NEAR_TIE = 0.125  # logits at full width reach ~4, where bf16 spacing is 1/32
# phase 6, fp32: the recurrence against the chunked scan at full depth, on
# logits of std ~1 (scripts/scan_precision_probe.py on an H100: 1.2e-3 at
# rwkv6-3b's 32 layers, 1.3e-4 at zamba2-7b's 81; a wrong scan is off by ~1)
SCAN_TOL = 1e-2
# Full-width olmoe-1b-7b (random weights; the experts' init std is 1/8, as
# JAX's fan-in rule gives) amplifies a bf16 rounding difference over its
# layers: with paged attention's plain version in the engine (the dense
# recipe over pages, differing from the dense decode in reduction order
# only) a replay of the tokens parts from the run in 2,274 of 6,016 top-k
# sets, the first at step 0, layer 7 (scripts/moe_route_divergence.py on an
# H100). So its tokens are held against the replay with the run's routing
# forced: each emitted token within NEAR_TIE_MOE of the replay's max logit,
# each routed expert within ROUTE_TIE of the replay router's own k-th
# largest logit (its logits spread ~0.9; a wrong expert lies ~1-3 below).
# Measured with the kernels: 0.2188 and 0.2539; with the plain version:
# 0.1094 and 0.1250.
NEAR_TIE_MOE = 0.5
ROUTE_TIE = 0.5
TOL = {"paged_attention": 2e-2, "flash_attention": 3e-2, "kv_log_append": 0.0, "log_compact": 0.0,
       "moe_ffn": 2e-2}
# the MoE routing kernels against their plain version: probabilities and
# gates in fp32 ulps (the route kernel's expf is the CUDA library's, compiled
# apart from torch's), the SwiGLU epilogue in bf16 ulps (an expf ulp on a
# bf16 rounding boundary); at decode (the first row count) a moe_ffn call
# launches MOE_FFN_OPS device ops at most: the router's matmul, route,
# slots, dispatch, two expert GEMMs, the epilogue, a GEMM, combine
TOL_MOE_GATE_ULPS, TOL_MOE_EPILOGUE_ULPS = 2, 1
MOE_ROUTING_ROWS = (32, 768, 2048)
MOE_FFN_OPS = 9
# the fused K/V epilogue, in bf16 ulps: it rounds where the plain ops do
# and sums the rmsnorm's squares in the order torch's CUDA reduction uses;
# a torch that sums otherwise can move a rounding by an ulp
TOL_EPILOGUE_ULPS = 1
REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:117",
    "log_compact": "src/repro/kernels/log_compact/kernel.py:86",
    "kv_log_append": "src/repro/kernels/kv_log_append/kernel.py:45",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:107",
    "moe_routing": "none: src/repro/models/layers.py:293 moe_ffn's routing glue is plain jnp",
    "mamba_step": "none: src/repro/models/mamba2.py decodes Mamba2 in plain jnp",
    "rms_norm_rows": "none: the RMSNorm is plain jnp (src/repro/models/layers.py)",
    "ssd_scan": "none: src/repro/models/mamba2.py scans Mamba2's prefill in plain jnp",
}


@contextlib.contextmanager
def phase(name):
    print(f"[{name}] ...", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s", flush=True)
        raise
    print(f"[{name}] ok ({time.perf_counter() - t0:.1f}s)", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean time of ``fn`` on the card (CUDA events around ``iters`` calls
    issued back to back: for a call shorter than its host dispatch this is
    the dispatch rate, not device time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def union_ms(events) -> float:
    """Device time covered by ``events`` (profiler kernel events), counting
    overlapping kernels once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_start, cur_end = 0.0, None, None
    for a, b in spans:
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        total += cur_end - cur_start
    return total / 1e3


def device_ms(fn, iters=10, required=True):
    """(device ms a call, device ops a call) of ``fn`` from a short
    torch.profiler window: the span of the kernels each call ran on the
    card (overlapping kernels counted once), without the host's dispatch.
    A window in which the profiler records no device op is taken again (up
    to three times); then it fails, or gives (None, None) where the caller
    does not require the number (a library yardstick)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        on_device = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                           key=lambda e: e.time_range.start)
        if on_device and len(on_device) % iters == 0:
            per = len(on_device) // iters
            return sum(union_ms(on_device[i * per:(i + 1) * per]) for i in range(iters)) / iters, per
        print(f"  (the profiler saw {len(on_device)} device ops in {iters} calls; taking the window again)")
    if required:
        raise AssertionError("the profiler saw no whole calls on the device in three windows")
    return None, None


def window_ms(fn, iters=10, required=True):
    """(device ms a call, device ops a call) of ``fn`` from one profiler
    window: the union of every device op of ``iters`` back-to-back calls,
    over ``iters``. For calls whose ops the profiler does not count alike
    each time (an autograd backward under the full run: 1,266 ops in 10
    calls where one call alone has 128), which ``device_ms`` cannot split
    call by call. Retried as ``device_ms`` when the window is empty."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if on_device:
            return union_ms(on_device) / iters, len(on_device) / iters
        print(f"  (the profiler saw no device op in {iters} calls; taking the window again)")
    if required:
        raise AssertionError("the profiler saw no device op in three windows")
    return None, None


def launched_in(events, names):
    """({name: device ms}, {name: device ops}, unlinked) of the device ops
    launched inside the host ranges called ``names`` in a profile: an op
    belongs to the range in which its launch falls (the runtime call that
    shares its correlation id). Ops launched through ctypes count too: the
    profiler links them to their runtime call but to no aten op, so a
    range's ``device_time_total`` leaves them out. ``unlinked``: device ops
    whose launch the profile does not hold."""
    import bisect

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == cpu and e.name in names)
    starts = [r[0] for r in ranges]
    launch_at = {e.id: e.time_range.start for e in events if e.device_type == cpu and e.name.startswith("cu")}
    ms, ops, unlinked = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0), 0
    for e in events:
        if e.device_type != cuda or e.is_user_annotation:
            continue
        if e.id not in launch_at:
            unlinked += 1
            continue
        i = bisect.bisect_right(starts, launch_at[e.id]) - 1
        if i >= 0 and launch_at[e.id] <= ranges[i][1]:
            ms[ranges[i][2]] += e.time_range.elapsed_us() / 1e3
            ops[ranges[i][2]] += 1
    return ms, ops, unlinked


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_BF16):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def timed(kernel, plain, library, err, bound, device=device_ms):
    """One row of phase 3: CUDA-event and profiler times of the kernel, its
    plain version and the library yardstick (``device``: how a profiler
    window is read)."""
    dev, ops = device(kernel)
    plain_dev, plain_ops = device(plain)
    return dict(
        max_abs_err=err, ms=cuda_ms(kernel), device_ms=dev, device_ops=ops, plain_ms=cuda_ms(plain),
        plain_device_ms=plain_dev, plain_device_ops=plain_ops,
        library_ms=None if library is None else cuda_ms(library),
        library_device_ms=None if library is None else device(library, required=False)[0], bound=bound,
    )


def bf16_ulps(a, b) -> int:
    """Largest distance between two bf16 tensors in units in the last place
    (bit patterns mapped to a monotone integer line; +0 and -0 both 0)."""
    def line(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((line(a) - line(b)).abs().max())


def check_close(name, got, want, tol):
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{name}: max abs err {err} (tol {tol})")
    return err


def check_kernels(full):
    """Phase 3: each kernel vs its plain version at ``full``'s shapes."""
    from repro_torch.kernels import reset_launch_counts, route_counts
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.kv_log_append.ops import kv_log_append, qkv_log_append
    from repro_torch.kernels.kv_log_append.ref import kv_log_append_ref, qkv_log_append_ref
    from repro_torch.kernels.log_compact.ops import log_compact, log_compact_tiers
    from repro_torch.kernels.log_compact.ref import log_compact_ref, log_compact_tiers_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention_pages, paged_decode_attention
    from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref
    from repro_torch.models.layers import AttnParams

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    H, KV, hd, L = full.n_heads, full.n_kv_heads, full.resolved_head_dim, full.n_layers
    g = H // KV
    page, B, S_log, P, N = 16, 4, 64, 96, 40
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

    rows = {}

    # ---- paged attention: a decode step's read of one layer ----
    q = randn(B, H, hd)
    pool_k, pool_v = randn(P, page, KV, hd), randn(P, page, KV, hd)
    log_k, log_v = randn(S_log, KV, hd), randn(S_log, KV, hd)
    plen = torch.tensor([400, 496, 288, 0], dtype=torch.int32, device=dev)  # row 3 is padding
    n_log = [11, 9, 13, 0]
    req = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=dev)
    perm = torch.randperm(P, generator=gen, device=dev).tolist()
    table = torch.full((B, N), -1, dtype=torch.int32)
    meta = torch.full((S_log, 2), -1, dtype=torch.int32)
    used, slot_iter = 0, iter(torch.randperm(S_log).tolist())
    for b in range(3):
        npg = -(-int(plen[b]) // page)
        table[b, :npg] = torch.tensor(perm[used:used + npg])
        used += npg
        for i in range(n_log[b]):  # positions past the watermark live in the log
            meta[next(slot_iter)] = torch.tensor([b, int(plen[b]) + i])
    table, meta = table.to(dev), meta.to(dev)
    lengths = plen + torch.tensor(n_log, dtype=torch.int32, device=dev)
    args = (q, pool_k, pool_v, table, lengths, log_k, log_v, meta)
    live = req >= 0

    def op():
        return paged_decode_attention(*args, page_lengths=plen, req_ids=req)

    reset_launch_counts()
    got = op()
    want = paged_decode_attention_ref(*args, page_lengths=plen, req_ids=req)
    err = check_close("paged attention (with the log)", got[live], want[live], TOL["paged_attention"])
    if not torch.isfinite(got).all():
        raise AssertionError("paged attention: non-finite output (padded row?)")
    # the yardstick: sdpa over pre-gathered pages with the valid log rows
    # concatenated, under the same mask (the gather stays outside the timing)
    gk = pool_k[table.clamp(min=0).long()].reshape(B, N * page, KV, hd)
    gv = pool_v[table.clamp(min=0).long()].reshape(B, N * page, KV, hd)
    page_mask = torch.arange(N * page, device=dev)[None] < plen[:, None]
    log_valid = (meta[None, :, 0] == req[:, None]) & (req[:, None] >= 0) & (meta[None, :, 1] < lengths[:, None])
    ck = torch.cat([gk, log_k[None].expand(B, S_log, KV, hd)], 1).repeat_interleave(g, 2).transpose(1, 2)
    cv = torch.cat([gv, log_v[None].expand(B, S_log, KV, hd)], 1).repeat_interleave(g, 2).transpose(1, 2)
    cmask = torch.cat([page_mask, log_valid], 1)[:, None, None, :]
    valid_tok, valid_log = int(plen.sum()), int(log_valid.sum())
    nbytes = (2 * (valid_tok + valid_log) * KV * hd * 2 + 2 * q.numel() * 2 + table.numel() * 4
              + meta.numel() * 4 + 3 * B * 4)
    rows["paged_attention"] = timed(
        op, lambda: paged_decode_attention_ref(*args, page_lengths=plen, req_ids=req),
        lambda: sdpa(q[:, :, None], ck, cv, attn_mask=cmask), err,
        bound_ms(nbytes, 4.0 * H * hd * (valid_tok + valid_log)),
    )
    if rows["paged_attention"]["device_ops"] != 2:
        raise AssertionError(f"paged attention: {rows['paged_attention']['device_ops']} device ops a call, want 2")
    # the kernels without the log (the page pass alone, as timed before the log was fused)
    got = paged_attention_pages(q, pool_k, pool_v, table, plen)
    want = paged_decode_attention_ref(q, pool_k, pool_v, table, plen)
    err = check_close("paged attention (pages)", got[:3], want[:3], TOL["paged_attention"])
    gkt, gvt = gk.repeat_interleave(g, 2).transpose(1, 2), gv.repeat_interleave(g, 2).transpose(1, 2)
    nbytes = 2 * valid_tok * KV * hd * 2 + 2 * q.numel() * 2 + table.numel() * 4 + B * 4
    rows["paged_attention"]["extra"] = [dict(
        shape="pages only (paged_attention_pages)",
        **timed(lambda: paged_attention_pages(q, pool_k, pool_v, table, plen),
                lambda: paged_decode_attention_ref(q, pool_k, pool_v, table, plen),
                lambda: sdpa(q[:, :, None], gkt, gvt, attn_mask=page_mask[:, None, None, :]), err,
                bound_ms(nbytes, 4.0 * H * hd * valid_tok)),
    )]

    # ---- flash attention: one layer of a prefill at ragged lengths ----
    flash_rows = []
    for S in (381, 517):  # phase 3's prompt, and the longest prompt of the run
        fq, fk, fv = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
        reset_launch_counts()
        got = flash_attention(fq, fk, fv, causal=True)
        if route_counts() != {"tensor_core": 1, "cuda_core": 0}:
            raise AssertionError(f"flash attention (bf16) did not take the tensor-core route: {route_counts()}")
        want = flash_attention_ref(fq, fk, fv, causal=True)
        err = check_close(f"flash attention S={S}", got, want, TOL["flash_attention"])
        qt = fq.transpose(1, 2)
        kt, vt = fk.repeat_interleave(g, 2).transpose(1, 2), fv.repeat_interleave(g, 2).transpose(1, 2)
        pairs = S * (S + 1) // 2
        flash_rows.append(dict(shape=f"S={S}", **timed(
            lambda: flash_attention(fq, fk, fv, causal=True),
            lambda: flash_attention_ref(fq, fk, fv, causal=True),
            lambda: sdpa(qt, kt, vt, is_causal=True), err,
            bound_ms(2 * (2 * fq.numel() + 2 * fk.numel()), 4.0 * H * hd * pairs),
        )))
    rows["flash_attention"] = flash_rows[0]
    rows["flash_attention"]["extra"] = flash_rows[1:]

    # ---- kv log append, as the decode step runs it: one layer's K/V
    # epilogue (qk-norm, RoPE; qwen3 has no bias) fused into the append ----
    tail = 20
    base_k, base_v = randn(S_log, KV, hd), randn(S_log, KV, hd)
    pos = torch.tensor([411, 505, 301, 0], dtype=torch.int32, device=dev)  # row 3 is padding
    meta_pos = torch.where(req >= 0, pos, -1)
    raw = [randn(B, 1, n * hd) for n in (H, KV, KV)]
    gains = [(1.0 + 0.2 * torch.randn(hd, generator=gen, device=dev)).to(bf16) for _ in range(2)]
    ap = AttnParams(wq=None, wk=None, wv=None, wo=None, q_norm=gains[0], k_norm=gains[1])
    outs = []
    for fn in (qkv_log_append, qkv_log_append_ref):
        lk, lv = base_k.clone(), base_v.clone()
        lm = torch.full((S_log, 2), -1, dtype=torch.int32, device=dev)
        q_out, _ = fn(full, ap, *raw, pos, lk, lv, lm, tail, req, meta_pos)
        outs.append((q_out, lk, lv, lm))
    torch.cuda.synchronize()
    if not torch.equal(outs[0][3], outs[1][3]):
        raise AssertionError("kv_log_append (fused epilogue): meta rows differ from the plain version")
    ulps = max(bf16_ulps(a, b) for a, b in zip(outs[0][:3], outs[1][:3]))
    if ulps > TOL_EPILOGUE_ULPS or not all(torch.isfinite(a).all() for a in outs[0][:3]):
        raise AssertionError(f"kv_log_append (fused epilogue): {ulps} bf16 ulps from the plain version "
                             f"(tol {TOL_EPILOGUE_ULPS})")
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs[0][:3], outs[1][:3]))
    print(f"  kv_log_append (fused epilogue): {ulps} bf16 ulps (tol {TOL_EPILOGUE_ULPS}), max abs err {err:.3g}")
    _, lk, lv, lm = outs[0]
    moved = sum(t.numel() for t in raw) * 2 + B * H * hd * 2 + 2 * B * KV * hd * 2  # read raw, write q, k, v
    small = 2 * hd * 2 + hd // 2 * 4 + 3 * B * 4 + B * 2 * 4  # gains, freqs, positions, ids, meta rows
    flops = 16.0 * B * (H + KV) * hd  # rmsnorm and RoPE, fp32 outside the tensor cores
    rows["kv_log_append"] = dict(shape="fused K/V epilogue + append (qkv_log_append), one layer", **timed(
        lambda: qkv_log_append(full, ap, *raw, pos, lk, lv, lm, tail, req, meta_pos),
        lambda: qkv_log_append_ref(full, ap, *raw, pos, lk, lv, lm, tail, req, meta_pos),
        None, err, bound_ms(moved + small, flops, PEAK_FP32),
    ))
    rows["kv_log_append"]["ulps"] = ulps

    # ---- the standalone append (the Pallas kernel's counterpart) ----
    k_new, v_new = randn(1, B, KV, hd), randn(1, B, KV, hd)
    outs = []
    for fn in (kv_log_append, kv_log_append_ref):
        lk, lv = base_k[None].clone(), base_v[None].clone()
        lm = torch.full((S_log, 2), -1, dtype=torch.int32, device=dev)
        fn(lk, lv, lm, tail, k_new, v_new, req, meta_pos)
        outs.append((lk, lv, lm))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        if not torch.equal(a.view(torch.int16) if a.dtype == bf16 else a, b.view(torch.int16) if b.dtype == bf16 else b):
            raise AssertionError("kv_log_append: kernel and plain version differ")
    lk, lv, lm = outs[0]

    def library_append():  # the same function: K, V and both meta columns
        lk[:, tail:tail + B].copy_(k_new)
        lv[:, tail:tail + B].copy_(v_new)
        lm[tail:tail + B, 0].copy_(req)
        lm[tail:tail + B, 1].copy_(meta_pos)

    rows["kv_log_append"]["extra"] = [dict(shape="standalone append (kv_log_append)", **timed(
        lambda: kv_log_append(lk, lv, lm, tail, k_new, v_new, req, meta_pos),
        lambda: kv_log_append_ref(lk, lv, lm, tail, k_new, v_new, req, meta_pos),
        library_append, 0.0, bound_ms(2 * 2 * k_new.numel() * 2 + 4 * B * 4, 0.0),
    ))]

    # ---- log compaction: a full log of 4 requests into both tiers ----
    n_host = 8 * N  # the serving run's host tier: 8 requests x 40 pages
    fk, fv = randn(L, P, page, KV, hd), randn(L, P, page, KV, hd)
    hk, hv = randn(L, n_host, page, KV, hd), randn(L, n_host, page, KV, hd)
    lk, lv = randn(L, S_log, KV, hd), randn(L, S_log, KV, hd)
    starts = [405, 218, 333, 470]  # 16 tokens each, straddling two pages
    meta_rows = [[r, starts[r] + i] for i in range(16) for r in range(4)]
    pages = sorted({(r, p // page) for r, p in meta_rows})
    targets = [[r, lp, perm[j], r * N + lp] for j, (r, lp) in enumerate(pages)]  # every page resident
    cmeta = torch.tensor(meta_rows, dtype=torch.int32, device=dev)
    ctargets = torch.tensor(targets, dtype=torch.int32, device=dev)
    outs = []
    for fn in (log_compact_tiers, log_compact_tiers_ref):
        pools = [t.clone() for t in (fk, fv, hk, hv)]
        fn(*pools, lk, lv, cmeta, ctargets)
        outs.append(pools)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            raise AssertionError("log_compact (two tiers): kernel and plain version differ")
    pools = outs[0]
    del outs
    # the yardstick: index_copy_ of the matched log rows into both tiers
    # (the newest slot of each page row; indices built here, outside the timing)
    newest = {(r, p): s for s, (r, p) in enumerate(meta_rows)}
    src = torch.tensor(list(newest.values()), device=dev)
    slot_of = {(r, lp): (fs, hs) for r, lp, fs, hs in targets}
    dst_fast = torch.tensor([slot_of[(r, p // page)][0] * page + p % page for r, p in newest], device=dev)
    dst_host = torch.tensor([slot_of[(r, p // page)][1] * page + p % page for r, p in newest], device=dev)
    flat = [t.view(L, -1, KV, hd) for t in pools]

    def library_compact():
        for log, fast, host in ((lk, flat[0], flat[2]), (lv, flat[1], flat[3])):
            rows_ = log.index_select(1, src)
            fast.index_copy_(1, dst_fast, rows_)
            host.index_copy_(1, dst_host, rows_)

    check = [t.clone() for t in pools]
    library_compact()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(check, pools)):
        raise AssertionError("log_compact: the index_copy_ yardstick computes another function")
    del check
    moved = L * len(newest) * KV * hd * 2 * 2  # K and V rows of the log that match
    rows["log_compact"] = dict(shape="two tiers, one launch (log_compact_tiers)", **timed(
        lambda: log_compact_tiers(*pools, lk, lv, cmeta, ctargets),
        lambda: log_compact_tiers_ref(*pools, lk, lv, cmeta, ctargets),
        library_compact, 0.0, bound_ms(3 * moved + cmeta.numel() * 4 + ctargets.numel() * 4, 0.0),
    ))
    one_pool = ctargets[:, :3].contiguous()
    outs = []
    for fn in (log_compact, log_compact_ref):
        pk, pv = fk.clone(), fv.clone()
        fn(pk, pv, lk, lv, cmeta, one_pool)
        outs.append((pk, pv))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            raise AssertionError("log_compact (one pool): kernel and plain version differ")
    pk, pv = outs[0]
    flat_one = [t.view(L, -1, KV, hd) for t in (pk, pv)]

    def library_compact_one():  # index_copy_ of the matched log rows into the one pool
        for log, fast in ((lk, flat_one[0]), (lv, flat_one[1])):
            fast.index_copy_(1, dst_fast, log.index_select(1, src))

    check = [pk.clone(), pv.clone()]
    library_compact_one()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(check, (pk, pv))):
        raise AssertionError("log_compact: the one-pool index_copy_ yardstick computes another function")
    del check
    rows["log_compact"]["extra"] = [dict(shape="one pool (log_compact)", **timed(
        lambda: log_compact(pk, pv, lk, lv, cmeta, one_pool),
        lambda: log_compact_ref(pk, pv, lk, lv, cmeta, one_pool),
        library_compact_one, 0.0, bound_ms(2 * moved + cmeta.numel() * 4 + one_pool.numel() * 4, 0.0),
    ))]
    del fk, fv, hk, hv, pools, flat, flat_one, outs, pk, pv
    torch.cuda.empty_cache()

    def show(name, r):
        lib_dev = "not measured" if r["library_device_ms"] is None else f"{r['library_device_ms']:.4f}"
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms (device {lib_dev})"
        print(f"  {name:34s} err {r['max_abs_err']:.3g}  kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
              f"{r['device_ops']:.0f} ops)  plain {r['plain_ms']:.4f} ms (device {r['plain_device_ms']:.4f}, "
              f"{r['plain_device_ops']:.0f} ops)  library {lib}  "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")

    print(f"  at {full.name}'s shapes (H={H}, KV={KV}, group {g}):")
    for name, r in rows.items():
        show(name + (f" {r['shape']}" if "shape" in r else ""), r)
        for x in r.get("extra", []):
            show(f"{name} {x['shape']}", x)
    return rows


def f32_ulps(a, b) -> int:
    """Largest distance between two fp32 tensors in units in the last place."""
    def line(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((line(a) - line(b)).abs().max())


def check_moe_routing(cfg):
    """Phase 3, the MoE's routing glue (``kernels/moe_routing``) at ``cfg``'s
    widths against its plain version (``ref.py``), at a decode step's rows
    and at two prefills' (``MOE_ROUTING_ROWS``), the rows sharing a
    component so that the favoured experts overflow their capacity. The
    routing exact: logits, ids, pos, keep and the dispatch buffer bit for
    bit; probabilities and gates within TOL_MOE_GATE_ULPS, the epilogue
    within TOL_MOE_EPILOGUE_ULPS, the combine within 2^-7 of the sum of
    its terms' magnitudes (tests/test_torch_gpu.py::test_moe_routing_kernels
    gives the reasons). Rows: each kernel (``moe_route`` with the router's
    matmul, as the layer calls it), and a whole ``moe_ffn`` against the
    plain bodies, with its device-op count (MOE_FFN_OPS at most at decode).
    No library row: no one PyTorch call computes any of the five."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.moe_routing import ops, ref
    from repro_torch.models import layers

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m, d = cfg.moe, cfg.d_model
    E, k, f = m.num_experts, m.top_k, m.d_ff_expert

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    w_router, w_gate, w_up = rand(d, E, scale=d ** -0.5), rand(E, d, f, scale=d ** -0.5), rand(E, d, f, scale=d ** -0.5)
    w_down = rand(E, f, d, scale=f ** -0.5)
    weight_bytes = 2 * (d * E + 3 * E * d * f)
    rows, ulps = [], {}
    for T in MOE_ROUTING_ROWS:
        xt = rand(T, d) + rand(1, d)
        cap = max(1, int(T * k * m.capacity_factor / E))
        N = T * k
        reset_launch_counts()
        got, want = ops.moe_route(m, xt, w_router), ref.moe_route(m, xt, w_router)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])):
            raise AssertionError(f"moe_route T={T}: logits or ids differ from the plain version")
        gate_ulps = max(f32_ulps(got[1], want[1]), f32_ulps(got[2], want[2]))
        _, _, gates, idx = got
        pos, keep = ops.moe_slots(idx, E, cap)
        rpos, rkeep = ref.moe_slots(idx, E, cap)
        torch.cuda.synchronize()
        if not (torch.equal(pos, rpos) and torch.equal(keep, rkeep)):
            raise AssertionError(f"moe_slots T={T}: pos or keep differ from the plain version")
        if bool(keep.all()):
            raise AssertionError(f"moe_slots T={T}: no pair dropped, the capacity is not exercised")
        buf = ops.moe_dispatch(xt, idx, pos, keep, E, cap)
        if not torch.equal(buf.view(torch.int16), ref.moe_dispatch(xt, idx, pos, keep, E, cap).view(torch.int16)):
            raise AssertionError(f"moe_dispatch T={T}: the buffer differs from the plain version")
        h, u = torch.bmm(buf, w_gate), torch.bmm(buf, w_up)
        act = ops.swiglu_epilogue(h, u)
        epi_ulps = bf16_ulps(act, ref.swiglu_epilogue(h, u))
        eo = torch.bmm(act, w_down)
        out = ops.moe_combine(eo, idx, pos, gates, keep, cap)
        plain_out = ref.moe_combine(eo, idx, pos, gates, keep, cap)
        terms = ((gates * keep).to(eo.dtype).float()[..., None] * eo[idx, pos.clamp(0, cap - 1)].float()).abs()
        torch.cuda.synchronize()
        gap = (out.float() - plain_out.float()).abs()
        if gate_ulps > TOL_MOE_GATE_ULPS or epi_ulps > TOL_MOE_EPILOGUE_ULPS or \
                not bool((gap <= terms.sum(1) * 2.0 ** -7 * 1.01).all()):
            raise AssertionError(f"moe_routing T={T}: gates {gate_ulps} fp32 ulps (tol {TOL_MOE_GATE_ULPS}), "
                                 f"epilogue {epi_ulps} bf16 ulps (tol {TOL_MOE_EPILOGUE_ULPS}), combine max gap "
                                 f"{float(gap.max())}")
        if launch_counts()["moe_routing"] != 5:
            raise AssertionError(f"moe_routing T={T}: {launch_counts()['moe_routing']} launches, want 5")
        ulps[T] = {"gates_fp32": gate_ulps, "epilogue_bf16": epi_ulps}
        kept = int(keep.sum())
        print(f"  moe_routing T={T}: cap {cap}, {kept} of {N} pairs kept; routing bit-equal; gates {gate_ulps} "
              f"fp32 ulps, epilogue {epi_ulps} bf16 ulps, combine max abs err {float(gap.max()):.3g}")

        def plain_ffn():
            _, _, g_, i_ = ref.moe_route(m, xt, w_router)
            p_, k_ = ref.moe_slots(i_, E, cap)
            e_ = ref.moe_experts(ref.moe_dispatch(xt, i_, p_, k_, E, cap), w_gate, w_up, w_down)
            return ref.moe_combine(e_, i_, p_, g_, k_, cap)

        ffn_err = check_close(f"moe_ffn T={T}", layers.moe_ffn(cfg, xt[None], w_router, w_gate, w_up, w_down,
                                                                aux=False)[0][0], plain_ffn(), TOL["moe_ffn"])
        # bytes each kernel must move, each input byte once: the tokens with a
        # kept pair (dispatch), the distinct expert rows gathered (combine)
        tokens_kept = int(keep.any(1).sum())
        rows_gathered = int(torch.unique(idx * cap + pos.clamp(0, cap - 1)).numel())
        buf_bytes, act_bytes = E * cap * d * 2, E * cap * f * 2
        kernels = (
            ("route (with the router's matmul)", lambda: ops.moe_route(m, xt, w_router),
             lambda: ref.moe_route(m, xt, w_router), 0.0,
             bound_ms(T * d * 2 + d * E * 2 + 2 * T * E * 2 + 2 * T * E * 4 + N * 12, 2.0 * T * d * E)),
            ("slots", lambda: ops.moe_slots(idx, E, cap), lambda: ref.moe_slots(idx, E, cap), 0.0,
             bound_ms(N * 8 + N * 9, 0.0)),
            ("dispatch", lambda: ops.moe_dispatch(xt, idx, pos, keep, E, cap),
             lambda: ref.moe_dispatch(xt, idx, pos, keep, E, cap), 0.0,
             bound_ms(buf_bytes + tokens_kept * d * 2 + N * 8 + kept * 17, 0.0)),
            ("epilogue", lambda: ops.swiglu_epilogue(h, u), lambda: ref.swiglu_epilogue(h, u), 0.0,
             bound_ms(3 * act_bytes, 0.0)),
            ("combine", lambda: ops.moe_combine(eo, idx, pos, gates, keep, cap),
             lambda: ref.moe_combine(eo, idx, pos, gates, keep, cap), float(gap.max()),
             bound_ms(rows_gathered * d * 2 + N * 21 + T * d * 2, 0.0)),
            ("moe_ffn", lambda: layers.moe_ffn(cfg, xt[None], w_router, w_gate, w_up, w_down, aux=False),
             plain_ffn, ffn_err,
             bound_ms(weight_bytes + 2 * T * d * 2, 2.0 * T * d * E + 6.0 * E * cap * d * f)),
        )
        for name, kern, plain, err, bound in kernels:
            rows.append(dict(shape=f"{name}, T={T}, E={E}, k={k}, cap {cap}", T=T, kernel=name,
                             **timed(kern, plain, None, err, bound)))
        ffn = rows[-1]
        if T == MOE_ROUTING_ROWS[0] and ffn["device_ops"] > MOE_FFN_OPS:
            raise AssertionError(f"moe_ffn at T={T}: {ffn['device_ops']} device ops, want at most {MOE_FFN_OPS}")
        del buf, h, u, act, eo
        torch.cuda.empty_cache()
    for r in rows:
        print(f"  moe_routing {r['shape']:60s} err {r['max_abs_err']:.3g}  kernel {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}, {r['device_ops']:.0f} ops)  plain {r['plain_ms']:.4f} ms (device "
              f"{r['plain_device_ms']:.4f}, {r['plain_device_ops']:.0f} ops)  library null  "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return rows, ulps


def check_flash_family_shapes(shapes=None):
    """Phase 3, flash attention at phase 6's shapes, the train shape, a
    split rank's train shape and a sharded serving rank's prefill shape
    (bf16, tensor-core route), or at ``shapes`` (phase 12's): rows for the
    flash entry's ``extra``."""
    from repro_torch.kernels import reset_launch_counts, route_counts
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    if shapes is None:
        shapes = FLASH_FAMILY_SHAPES + (FLASH_TRAIN_SHAPE, FLASH_SPLIT_SHAPE, FLASH_SERVE_SHAPE) + \
            FLASH_SPLIT_FAMILY_SHAPES + FLASH_SPLIT_FAMILY_TRAIN_SHAPES
    for name, B, S, S_kv, H, KV, hd, causal in shapes:
        fq = torch.randn((B, S, H, hd), generator=gen, device=dev).to(torch.bfloat16)
        fk, fv = (torch.randn((B, S_kv, KV, hd), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        reset_launch_counts()
        got = flash_attention(fq, fk, fv, causal=causal)
        if route_counts() != {"tensor_core": 1, "cuda_core": 0}:
            raise AssertionError(f"flash attention ({name}) did not take the tensor-core route: {route_counts()}")
        err = check_close(f"flash attention {name}", got, flash_attention_ref(fq, fk, fv, causal=causal),
                          TOL["flash_attention"])
        qt, kt, vt = (t.transpose(1, 2) for t in (fq, fk.repeat_interleave(H // KV, 2), fv.repeat_interleave(H // KV, 2)))
        pairs = S * (S + 1) // 2 if causal else S * S_kv
        rows.append(dict(shape=f"{name}: B={B} S={S} S_kv={S_kv} H={H} KV={KV} hd={hd} "
                               f"{'causal' if causal else 'non-causal'}", **timed(
            lambda: flash_attention(fq, fk, fv, causal=causal),
            lambda: flash_attention_ref(fq, fk, fv, causal=causal),
            lambda: sdpa(qt, kt, vt, is_causal=causal), err,
            bound_ms(2 * (2 * fq.numel() + 2 * fk.numel()), 4.0 * B * H * hd * pairs),
        )))
    for r in rows:
        lib_dev = "not measured" if r["library_device_ms"] is None else f"{r['library_device_ms']:.4f}"
        print(f"  flash attention {r['shape']}: err {r['max_abs_err']:.3g}  kernel {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}, {r['device_ops']:.0f} ops)  plain {r['plain_ms']:.4f} ms (device "
              f"{r['plain_device_ms']:.4f})  sdpa {r['library_ms']:.4f} ms (device {lib_dev})  "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return rows


def decode_floor_bytes(cfg, params, cache, pos: int, batch: int) -> int:
    """Bytes one decode step must move at ``pos``: the weights it reads (the
    embedding's ``batch`` rows, not the table; not the encoder; zamba2's
    shared block once per invocation), the recurrent state read and
    written, and the valid K/V rows its attention reads."""
    from repro_torch.models.mamba2 import _split_counts

    skip = ("embed", "frontend_proj", "enc_norm")
    n = sum(t.numel() * t.element_size() for k, t in params.items() if k not in skip and not k.startswith("enc."))
    n += batch * cfg.d_model * params["embed"].element_size()
    if cfg.family == "hybrid":
        shared = sum(t.numel() * t.element_size() for k, t in params.items() if k.startswith("shared_attn."))
        n += (_split_counts(cfg)[0] - 1) * shared
    for key, t in cache.items():
        if key in ("wkv", "tm_prev", "cm_prev", "conv", "ssm"):
            n += 2 * t.numel() * t.element_size()  # read and written
        elif key in ("k", "v", "attn_k", "attn_v"):
            n += t[:, :, :pos + 1].numel() * t.element_size()  # the valid rows
        elif key in ("ck", "cv"):
            n += t.numel() * t.element_size()
    return n


def family_inputs(cfg, dev):
    """Phase 6's prompts (FAMILY_BATCH, FAMILY_PROMPT) int32 from the seed
    and, for an encdec, its frames: (FAMILY_PROMPT + FAMILY_NEW) // 4 of
    them from the same generator (phase 6's cross cache is exactly the
    frames), bf16; else None."""
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab - 1, size=(FAMILY_BATCH, FAMILY_PROMPT)).astype(np.int32))
    frontend = None
    if cfg.family == "encdec":
        frontend = torch.from_numpy(rng.normal(size=(FAMILY_BATCH, (FAMILY_PROMPT + FAMILY_NEW) // 4,
                                                     cfg.d_model)).astype(np.float32)).to(dev, torch.bfloat16)
    return prompt.to(dev), frontend


def serve_family(cfg, card):
    """Phase 6: full-width ``cfg`` through ``build_prefill_step`` and
    ``build_serve_step``. Returns (the main run's launch counts, the
    near-tie limit of its served tokens: max(NEAR_TIE, 2 x the bf16
    noise))."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.launch.steps import build_prefill_step, build_serve_step, decode_cache
    from repro_torch.models.api import ModelSpec

    dev = torch.device("cuda")
    spec = ModelSpec(cfg)
    B, S, n = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW
    max_len = S + n
    params = spec.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompt, frontend = family_inputs(cfg, dev)
    weights = sum(t.numel() * t.element_size() for t in params.values())
    print(f"  config {cfg.name}: {spec.param_count() / 1e9:.3f} B params ({weights / 1e9:.3f} GB); "
          f"{B} prompts of {S} tokens, {n} tokens each"
          + ("" if frontend is None else f"; frames {tuple(frontend.shape)}"))
    prefill_step, serve_step = build_prefill_step(spec), build_serve_step(spec)

    def into_decode_cache(cache):
        return decode_cache(spec, cache, B, max_len, device=dev)

    def generate(n_tokens):
        tok, cache = prefill_step(params, prompt, frontend)
        dc = into_decode_cache(cache)
        toks = [tok]
        for i in range(n_tokens - 1):
            tok, dc = serve_step(params, dc, tok, S + i)
            toks.append(tok)
        return torch.cat(toks, dim=1)

    generate(2)  # first calls: cuBLAS set-up, allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = generate(n)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, routes = launch_counts(), route_counts()
    print(f"  launches {counts}; flash routes {routes}; tok/s {B * n / dt:.1f} ({B * n} tokens in {dt:.3f}s, "
          f"prefill included) — on {card}")
    want = {name: 0 for name in counts}
    want["flash_attention"] = FAMILY_FLASH[cfg.name]
    if counts != want:
        raise AssertionError(f"launch counts {counts} differ from {want}")
    if routes != {"tensor_core": FAMILY_FLASH[cfg.name], "cuda_core": 0}:
        raise AssertionError(f"a flash call missed the tensor-core route: {routes}")

    # a decode step's time: 4 steps untraced, then 4 under the profiler
    tok, dc = prefill_step(params, prompt, frontend)
    dc = into_decode_cache(dc)
    for i in range(4):
        tok, dc = serve_step(params, dc, tok, S + i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(4, 8):
        tok, dc = serve_step(params, dc, tok, S + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 4 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(8, 12):
            tok, dc = serve_step(params, dc, tok, S + i)
        torch.cuda.synchronize()
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_device:
        raise AssertionError("the profiler saw no device op in the decode window")
    busy_ms = union_ms(on_device) / 4
    floor_ms, floor_by = bound_ms(decode_floor_bytes(cfg, params, dc, S + 10, B),
                                  2.0 * B * sum(t.numel() for t in params.values()))
    del dc
    by_name = {}
    for e in on_device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 4e3
    print(f"  decode step (untraced) {step_ms:.2f} ms; device busy {busy_ms:.3f} ms/step "
          f"({len(on_device) / 4:.0f} device ops/step); idle share {1 - busy_ms / step_ms:.3f}; "
          f"decode floor {floor_ms:.3f} ms ({floor_by}) — on {card}")
    for name, ms in sorted(by_name.items(), key=lambda kv_: -kv_[1])[:6]:
        print(f"    {ms:8.4f} ms/step  {name[:90]}")

    # The family's invariant: decode (the one-token recurrence) is the
    # prefill's function (the chunked scan). Logits of the forward over
    # prompt + emitted tokens against the decode's own, teacher-forced on
    # the run's tokens: in bf16 (the served run) and in fp32 (the same
    # weights). Random full-width weights amplify bf16 rounding to O(1)
    # logits over depth (ROADMAP.md §3), so the invariant is held in fp32
    # (SCAN_TOL) and the served tokens to the bf16 noise measured here.
    seq = torch.cat([prompt, out[:, :-1]], dim=1)

    def both_ways(p, fe):
        fwd = spec.forward(p, seq, fe)[0][:, S - 1:].float()
        first, cache = spec.prefill(p, prompt, fe)
        dc, rows = into_decode_cache(cache), [first]
        del cache
        for i in range(n - 1):
            lg, dc = spec.decode_step(p, dc, out[:, i:i + 1], S + i)
            rows.append(lg)
        return fwd, torch.stack(rows, dim=1).float()

    fwd16, dec16 = both_ways(params, frontend)
    if not torch.equal(torch.argmax(dec16, dim=-1).to(torch.int32), out):
        raise AssertionError("the teacher-forced bf16 decode does not reproduce the served tokens")
    params32 = {k: t.float() for k, t in params.items()}
    del params
    fwd32, dec32 = both_ways(params32, None if frontend is None else frontend.float())
    del params32
    if not all(torch.isfinite(t).all() for t in (fwd16, dec16, fwd32, dec32)):
        raise AssertionError("non-finite logits")
    scan_err = float((dec32 - fwd32).abs().max())
    noise_fwd, noise_dec = float((fwd16 - fwd32).abs().max()), float((dec16 - dec32).abs().max())
    gaps = fwd16.max(-1).values - fwd16.gather(-1, out.long()[..., None])[..., 0]
    worst, bound = float(gaps.max()), max(NEAR_TIE, 2 * (noise_fwd + noise_dec))
    print(f"  fp32: decode vs teacher-forced forward, max |logit diff| {scan_err:.3g} (tol {SCAN_TOL}); "
          f"bf16 noise (max |bf16 - fp32| logits): forward {noise_fwd:.4f}, decode {noise_dec:.4f}")
    print(f"  near-tie check: worst gap of a served token to the bf16 teacher-forced max logit {worst:.4f} "
          f"(tol max({NEAR_TIE}, 2 x noise) = {bound:.4f}); {int((gaps == 0).sum())}/{gaps.numel()} tokens "
          f"at the max")
    if scan_err > SCAN_TOL:
        raise AssertionError(f"fp32 decode is {scan_err} from the forward: the scan is not the recurrence")
    if worst > bound:
        raise AssertionError(f"a served token is {worst} below the teacher-forced max logit")
    return counts, bound


def zamba2_params(spec, dev):
    """The schema's draw on the card, with A_log and dt_bias as Mamba2
    initialises them (A = -U[1, 16], dt log-uniform in [1e-3, 0.1]), so the
    decays are those of a trained model's range."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = spec.init(gen, device=dev)
    for k, t in params.items():
        if k.endswith("A_log"):
            params[k] = torch.log(1 + 15 * torch.rand(t.shape, generator=gen, device=dev)).to(t.dtype)
        elif k.endswith("dt_bias"):
            dt = torch.exp(torch.rand(t.shape, generator=gen, device=dev) * math.log(100) + math.log(1e-3))
            params[k] = torch.log(torch.expm1(dt)).to(t.dtype)
    return params


def check_zamba2_kernels(cfg):
    """Phase 6b, the kernels: ``mamba_step`` (B 16 over 33 slots and B 12
    over 25, rows in scattered slots, a padded row in each), ``rms_norm_rows``
    (the step's row norms, 16 x 3584 and 16 x 7168), ``ssd_scan`` (a Mamba
    layer's prefill scan at 768, 2,048 and 300 positions), flash attention at hd
    224 (the cell's median and longest prompt), the fused K/V append at hd
    224 (a step's rows into a 192-slot log) and paged attention at hd 224
    (16 rows of ~900 positions: 56 pages and 6 log rows each), each against
    its plain version on the same card inputs, timed with its least time."""
    import torch.nn.functional as F

    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.kv_log_append.ops import qkv_log_append
    from repro_torch.kernels.kv_log_append.ref import qkv_log_append_ref
    from repro_torch.kernels.mamba_step.ops import mamba_step, rms_norm_rows
    from repro_torch.kernels.mamba_step.ref import mamba_step_ref
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import layers
    from repro_torch.models.layers import AttnParams

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    s = cfg.ssm
    H, P, N, G, W = s.heads, s.head_dim, s.state_dim, cfg.ssm_groups, s.conv_dim
    inner, C = H * P, H * P + 2 * G * N
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    rows = {"mamba_step": [], "rms_norm_rows": [], "ssd_scan": [], "flash_attention": [], "kv_log_append": [],
            "paged_attention": []}

    # ---- mamba_step: one token of a Mamba layer over the rows' slots ----
    w = dict(conv_w=randn(C, W, scale=0.3), conv_b=randn(C, scale=0.1),
             dt_bias=torch.log(torch.expm1(torch.exp(torch.rand(H, generator=gen, device=dev) * math.log(100)
                                                     + math.log(1e-3)))).to(bf),
             A_log=torch.log(1 + 15 * torch.rand(H, generator=gen, device=dev)).to(bf),
             D=(1 + 0.1 * randn(H, dtype=torch.float32)).to(bf),
             norm_w=(1 + 0.1 * randn(inner, dtype=torch.float32)).to(bf))
    for B in (16, 12):
        slots = 2 * B + 1  # the last the scratch slot
        zx, conv, ssm = randn(B, 2 * inner + 2 * G * N + H), randn(slots, W - 1, C), randn(slots, H, P, N,
                                                                                          dtype=torch.float32,
                                                                                          scale=0.5)
        req = torch.randperm(slots - 1, generator=gen, device=dev)[:B].to(torch.int32)
        req[B // 2] = -1
        args = (w["conv_w"], w["conv_b"], w["dt_bias"], w["A_log"], w["D"], w["norm_w"], req)
        outs = []
        reset_launch_counts()
        for fn in (mamba_step, mamba_step_ref):
            c, st = conv.clone(), ssm.clone()
            outs.append((fn(zx, c, st, *args, groups=G), c, st))
        if launch_counts()["mamba_step"] != 1:
            raise AssertionError(f"mamba_step: {launch_counts()['mamba_step']} launches for one call")
        (y, c, st), (y_ref, c_ref, st_ref) = outs
        torch.cuda.synchronize()
        live = req[req >= 0].long()
        untouched = torch.ones(slots, dtype=torch.bool, device=dev)
        untouched[live] = False
        untouched[-1] = False
        if not (torch.equal(c[untouched], conv[untouched]) and torch.equal(st[untouched], ssm[untouched])):
            raise AssertionError("mamba_step wrote a slot no live row names")
        if not torch.equal(c[live], c_ref[live]):
            raise AssertionError("mamba_step: the conv windows differ from the plain version's")
        err = float(((st[live] - st_ref[live]).abs() / (st_ref[live].abs() + 1.0)).max())
        if err > TOL_MAMBA_STATE:
            raise AssertionError(f"mamba_step: SSM states {err:.2e} from the plain version's")
        ulps = bf16_ulps(y[req >= 0], y_ref[req >= 0])
        check_close("mamba_step y", y[req >= 0], y_ref[req >= 0], TOL_MAMBA_Y)
        c, st = conv.clone(), ssm.clone()
        row = timed(lambda: mamba_step(zx, c, st, *args, groups=G), lambda: mamba_step_ref(zx, c, st, *args, groups=G),
                    None, err, bound_ms(B * (2 * (inner * N * 4 + (W - 1) * C * 2) + (2 * inner + 2 * G * N + H) * 2
                                             + inner * 2), 0.0))
        rows["mamba_step"].append(dict(row, shape=f"B {B} over {slots} slots, {H} heads of {P}, {G} groups, "
                                                  f"state {N}, conv {W}", ulps=ulps))

    # ---- rms_norm_rows: the step's row norms ----
    for d in (cfg.d_model, 2 * cfg.d_model):
        x, g = randn(16, d, scale=3.0), (1 + 0.2 * randn(d, dtype=torch.float32)).to(bf)
        reset_launch_counts()
        got = rms_norm_rows(x, g, cfg.norm_eps)
        if launch_counts()["rms_norm_rows"] != 1:
            raise AssertionError(f"rms_norm_rows: {launch_counts()['rms_norm_rows']} launches for one call")
        ulps = bf16_ulps(got, layers.rmsnorm(x, g, cfg.norm_eps))
        if ulps > TOL_NORM_ULPS:
            raise AssertionError(f"rms_norm_rows: {ulps} bf16 ulps from layers.rmsnorm")
        row = timed(lambda: rms_norm_rows(x, g, cfg.norm_eps), lambda: layers.rmsnorm(x, g, cfg.norm_eps), None,
                    float(ulps), bound_ms(2 * x.numel() * 2 + d * 2, 0.0))
        rows["rms_norm_rows"].append(dict(row, shape=f"16 x {d}", ulps=ulps))

    # ---- ssd_scan: one Mamba layer's prefill scan ----
    for S in (768, 2048, 300):
        xbc = F.silu(randn(1, S, C, dtype=torch.float32)).to(bf)
        dt = F.softplus(randn(1, S, H, dtype=torch.float32) + w["dt_bias"].float())
        loga = dt * -torch.exp(w["A_log"].float())
        kw = dict(heads=H, groups=G, state_dim=N, chunk=s.chunk)
        reset_launch_counts()
        y, st = ssd_scan(xbc, dt, loga, w["D"], **kw)
        if launch_counts()["ssd_scan"] != 1:
            raise AssertionError(f"ssd_scan: {launch_counts()['ssd_scan']} launches for one call")
        y_ref, st_ref = ssd_scan_ref(xbc, dt, loga, w["D"], **kw)
        torch.cuda.synchronize()
        if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
            raise AssertionError(f"ssd_scan S={S}: non-finite output")
        err = max(float(((y - y_ref).abs() / (y_ref.abs() + 1.0)).max()),
                  float(((st - st_ref).abs() / (st_ref.abs() + 1.0)).max()))
        if err > TOL_SSD_SCAN:
            raise AssertionError(f"ssd_scan S={S}: {err:.2e} from the plain version (relative to |plain| + 1)")
        pad = -(-S // s.chunk) * s.chunk
        flops = H * (pad // s.chunk) * (s.chunk ** 2 * (N + P) + 4 * s.chunk * N * P)
        nbytes = S * C * 2 + 2 * S * H * 4 + S * inner * 4 + H * P * N * 4
        row = timed(lambda: ssd_scan(xbc, dt, loga, w["D"], **kw), lambda: ssd_scan_ref(xbc, dt, loga, w["D"], **kw),
                    None, err, bound_ms(nbytes, flops, PEAK_FP32))
        rows["ssd_scan"].append(dict(row, shape=f"(1, {S}), {H} heads of {P}, {G} groups, state {N}, "
                                                f"chunk {s.chunk}", ulps=None))

    # ---- flash attention at hd 224: one site of a prefill ----
    for S in (768, 2048):
        q, k, v = randn(1, S, cfg.n_heads, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
        reset_launch_counts()
        got = flash_attention(q, k, v, causal=True)
        if route_counts() != {"tensor_core": 1, "cuda_core": 0}:
            raise AssertionError(f"flash attention at hd {hd} missed the tensor-core route: {route_counts()}")
        err = check_close(f"flash attention hd {hd} S={S}", got, flash_attention_ref(q, k, v, causal=True),
                          TOL["flash_attention"])
        nbytes = 4 * S * cfg.n_heads * hd * 2
        row = timed(lambda: flash_attention(q, k, v, causal=True), lambda: flash_attention_ref(q, k, v, causal=True),
                    None, err, bound_ms(nbytes, 4.0 * hd * cfg.n_heads * S * (S + 1) / 2))
        rows["flash_attention"].append(dict(row, shape=f"{ZAMBA2_ARCH} site, (1, {S}, {cfg.n_heads}, {hd}) causal"))

    # ---- the fused K/V append at hd 224: a step's 16 rows into the log ----
    B, S_log, tail = 16, ZAMBA2_KV["log_slots"], 40
    raw = (randn(B, 1, cfg.n_heads * hd), randn(B, 1, KV * hd), randn(B, 1, KV * hd))
    ap = AttnParams(wq=None, wk=None, wv=None, wo=None)
    pos = torch.randint(0, 2000, (B,), generator=gen, device=dev, dtype=torch.int32)
    req = torch.arange(B, dtype=torch.int32, device=dev)
    log_k, log_v = randn(S_log, KV, hd), randn(S_log, KV, hd)
    outs = []
    reset_launch_counts()
    for fn in (qkv_log_append, qkv_log_append_ref):
        lk, lv, meta = log_k.clone(), log_v.clone(), torch.full((S_log, 2), -1, dtype=torch.int32, device=dev)
        q = fn(cfg, ap, *raw, pos, lk, lv, meta, tail, req, pos)[0]
        outs.append((q, lk, lv, meta))
    if launch_counts()["kv_log_append"] != 1:
        raise AssertionError(f"qkv_log_append at hd {hd}: {launch_counts()['kv_log_append']} launches")
    torch.cuda.synchronize()
    if not torch.equal(outs[0][3], outs[1][3]):
        raise AssertionError(f"qkv_log_append at hd {hd}: the log's meta rows differ")
    ulps = max(bf16_ulps(a, b) for a, b in zip(outs[0][:3], outs[1][:3]))
    if ulps > TOL_EPILOGUE_224_ULPS:
        raise AssertionError(f"qkv_log_append at hd {hd}: {ulps} bf16 ulps from the plain version")
    lk, lv, meta = log_k.clone(), log_v.clone(), torch.full((S_log, 2), -1, dtype=torch.int32, device=dev)
    row = timed(lambda: qkv_log_append(cfg, ap, *raw, pos, lk, lv, meta, tail, req, pos),
                lambda: qkv_log_append_ref(cfg, ap, *raw, pos, lk, lv, meta, tail, req, pos), None, float(ulps),
                bound_ms(2 * sum(t.numel() for t in raw) * 2 + B * 8, 0.0))
    rows["kv_log_append"].append(dict(row, shape=f"{ZAMBA2_ARCH} site, B {B}, {KV} heads of {hd}, RoPE, "
                                                 f"{S_log} log slots", ulps=ulps))

    # ---- paged attention at hd 224: one site of a decode step ----
    page, n_pages, N_req, ctx, logged = 16, 1024, 160, 896, 6
    pool_k, pool_v = randn(n_pages, page, KV, hd), randn(n_pages, page, KV, hd)
    table = torch.full((B, N_req), -1, dtype=torch.int32, device=dev)
    table[:, :ctx // page] = torch.randperm(n_pages, generator=gen, device=dev)[:B * ctx // page].view(B, -1).int()
    plen = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    lengths = plen + logged
    meta = torch.full((S_log, 2), -1, dtype=torch.int32, device=dev)
    for i in range(B * logged):
        meta[i, 0], meta[i, 1] = i % B, ctx + i // B
    qd = randn(B, cfg.n_heads, hd)
    args = (qd, pool_k, pool_v, table, lengths, log_k, log_v, meta)
    reset_launch_counts()
    got = paged_decode_attention(*args, page_lengths=plen, req_ids=req)
    err = check_close(f"paged attention hd {hd}", got, paged_decode_attention_ref(*args, page_lengths=plen, req_ids=req),
                      TOL["paged_attention"])
    if launch_counts()["paged_attention"] != 1:
        raise AssertionError(f"paged attention at hd {hd}: {launch_counts()['paged_attention']} calls counted")
    nbytes = 2 * B * (ctx + logged) * KV * hd * 2 + 2 * qd.numel() * 2 + table.numel() * 4 + meta.numel() * 4
    row = timed(lambda: paged_decode_attention(*args, page_lengths=plen, req_ids=req),
                lambda: paged_decode_attention_ref(*args, page_lengths=plen, req_ids=req), None, err,
                bound_ms(nbytes, 4.0 * cfg.n_heads * hd * B * (ctx + logged)))
    rows["paged_attention"].append(dict(row, shape=f"{ZAMBA2_ARCH} site, B {B}, {cfg.n_heads} heads of {hd}, "
                                                   f"{ctx} paged + {logged} logged positions, {S_log} log slots"))
    for name, rs in rows.items():
        for r in rs:
            print(f"  {name} {r['shape']}: device {r['device_ms']:.4f} ms ({r['device_ops']} ops), plain "
                  f"{r['plain_device_ms']:.4f} ms ({r['plain_device_ops']} ops), bound {r['bound'][0]:.5f} ms "
                  f"({r['bound'][1]}), err {r['max_abs_err']:.3g}")
    return rows


def serve_zamba2(card):
    """Phase 6b, the engine: Zamba2-7B-Instruct at published width and depth
    through ``TieredEngine.add_request`` / ``step`` with the cell's KV
    settings. The launch counts, reset just before, are those of the
    prompts' prefills and the steps; the served tokens of ZAMBA2_CHECKED
    requests lie, on the mean, within ZAMBA2_GAP_MEAN of the plain float32
    reference's best logit. Returns the launch counts."""
    import dataclasses

    from repro_torch.configs import zamba2_7b_instruct
    from repro_torch.core.tiering import TieredKVConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.models.api import ModelSpec
    from repro_torch.models.zamba2_ref import Zamba2Reference
    from repro_torch.serving.engine import Request, TieredEngine

    dev = torch.device("cuda")
    cfg = zamba2_7b_instruct()
    spec = ModelSpec(cfg)
    params = zamba2_params(spec, dev)
    kv = TieredKVConfig(batch=ZAMBA2_BATCH, max_requests=ZAMBA2_BATCH, **ZAMBA2_KV)
    eng = TieredEngine(spec, params, kv, device=dev)
    rng = np.random.default_rng(SEED)
    prompts = {rid: [int(t) for t in rng.integers(0, cfg.vocab, size=n)] for rid, n in enumerate(ZAMBA2_PROMPTS)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    for rid, p in prompts.items():
        eng.add_request(Request(rid=rid, prompt=p, max_new_tokens=ZAMBA2_NEW))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step_s = []
    while eng.stats.steps < ZAMBA2_STEPS and len(step_s) < 2 * ZAMBA2_STEPS:  # a call may only promote
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
    counts, routes, stats = launch_counts(), route_counts(), eng.stats
    n = len(prompts)
    want = {"paged_attention": ZAMBA2_SITES * stats.steps, "kv_log_append": ZAMBA2_SITES * stats.steps,
            "flash_attention": ZAMBA2_SITES * n, "log_compact": stats.compactions, "moe_routing": 0,
            "mamba_step": ZAMBA2_LAYERS * stats.steps, "rms_norm_rows": ZAMBA2_NORMS * (stats.steps + n),
            "ssd_scan": ZAMBA2_LAYERS * n}
    print(f"  {cfg.name}: {spec.param_count() / 1e9:.3f} B params; {n} prefills {t1 - t0:.3f}s; {stats.steps} steps "
          f"in {len(step_s)} calls, {stats.decoded_tokens} tokens, "
          f"median {sorted(step_s)[len(step_s) // 2] * 1e3:.2f} ms; {stats.compactions} compactions; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches {counts}; flash routes {routes} — on {card}")
    if stats.steps != ZAMBA2_STEPS or stats.compactions < 2:
        raise AssertionError(f"the run must make {ZAMBA2_STEPS} steps and compact twice: {stats}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} differ from {want}")
    if routes != {"tensor_core": ZAMBA2_SITES * n, "cuda_core": 0}:
        raise AssertionError(f"a flash call missed the tensor-core route: {routes}")
    ref = Zamba2Reference(dataclasses.asdict(cfg), params)
    gaps = []
    for rid in sorted(prompts, key=lambda r: -len(prompts[r]))[:ZAMBA2_CHECKED]:
        served = list(eng.requests[rid].out)
        toks = torch.as_tensor(prompts[rid] + served[:-1], device=dev)
        lg = ref.forward(toks)[len(prompts[rid]) - 1:]
        idx = torch.arange(len(served), device=dev)
        gaps += (lg.max(-1).values - lg[idx, torch.as_tensor(served, device=dev)]).tolist()
        del lg
    mean = sum(gaps) / len(gaps)
    print(f"  served tokens against the float32 reference: {len(gaps)} tokens of {ZAMBA2_CHECKED} requests, gap mean "
          f"{mean:.5f} (limit {ZAMBA2_GAP_MEAN}), widest {max(gaps):.4f}")
    if not mean <= ZAMBA2_GAP_MEAN:
        raise AssertionError(f"served tokens: gap mean {mean} over {ZAMBA2_GAP_MEAN}")
    return counts


@contextlib.contextmanager
def patched(module, name, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def routing_recorder(rows: int, into: list):
    """A wrapper of ``layers.moe_route`` that keeps the (router logits,
    top-k expert ids) of every call with ``rows`` tokens (the decode steps';
    prefills have hundreds)."""
    def wrap(route):
        def recorded(m, xt, w_router):
            out = route(m, xt, w_router)
            if xt.shape[0] == rows:
                into.append((out[0], out[3]))
            return out
        return recorded
    return wrap


def routing_disagreement(run, replay, batches, n_layers):
    """(number of live (step, layer, row) top-k sets that differ, the first
    (step, layer) where one does, the largest amount by which an expert the
    run chose lies below the replay router's own k-th largest logit)."""
    differ, first, deficit = 0, None, 0.0
    for i, ((_, a), (logits, b)) in enumerate(zip(run, replay)):
        live = batches[i // n_layers][1] >= 0
        n = int((a.sort(-1).values != b.sort(-1).values).any(-1)[live].sum())
        if n and first is None:
            first = divmod(i, n_layers)
        differ += n
        short = logits.gather(-1, b[:, -1:]) - logits.gather(-1, a)  # >= 0 below the k-th
        deficit = max(deficit, float(short.amax(-1)[live].max()))
    return differ, first, deficit


def serve(full, reduced, card, prompts):
    """Phases 4 and 5: full-width ``full`` through the port's TieredEngine."""
    from repro_torch.core.tiering import TieredKVConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.launch.serve import baseline_serve, dense_decode, replay_dense
    from repro_torch.models import layers
    from repro_torch.models.api import ModelSpec
    from repro_torch.serving.engine import Request, TieredEngine

    moe = full.family == "moe"
    kv = TieredKVConfig(page_size=16, n_hbm_pages=96, max_requests=8, max_pages_per_req=40,
                        log_slots=64, batch=4, promote_pages_per_step=8)
    demand = sum(-(-(len(p) + NEW_TOKENS) // kv.page_size) for p in prompts.values())
    print(f"  config {full.name}: {ModelSpec(full).param_count() / 1e9:.3f} B params; {kv}")
    print(f"  prompts {[len(p) for p in prompts.values()]} x {NEW_TOKENS} new tokens; page demand {demand} > "
          f"fast pool {kv.n_hbm_pages}")
    prompts = {rid: [t % full.vocab for t in p] for rid, p in prompts.items()}
    routes_tiered, routes_replay = [], []

    def run_engine(spec, params, vocab, device, batches=None):
        eng = TieredEngine(spec, params, kv, device=device)
        if batches is not None:  # keep each step's inputs (device tensors: no sync)
            inner = eng.step_fn

            def step(params_, state, tokens, req_ids):
                batches.append((tokens, req_ids))
                return inner(params_, state, tokens, req_ids)

            eng.step_fn = step
        t0 = time.perf_counter()
        for rid, p in prompts.items():
            eng.add_request(Request(rid=rid, prompt=[t % vocab for t in p], max_new_tokens=NEW_TOKENS))
        stats = eng.run(max_steps=5000)
        if device == "cuda":
            torch.cuda.synchronize()
        return eng, stats, time.perf_counter() - t0

    spec = ModelSpec(full)
    params = spec.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    warm = TieredEngine(spec, params, kv, device="cuda")  # first calls: cuBLAS set-up, allocator
    warm.add_request(Request(rid=0, prompt=prompts[0][:40], max_new_tokens=4))
    warm.run()
    del warm
    batches = []
    reset_launch_counts()
    with patched(layers, "moe_route", routing_recorder(kv.batch, routes_tiered)):
        eng, stats, dt = run_engine(spec, params, full.vocab, "cuda", batches)
    counts, routes = launch_counts(), route_counts()
    print(f"  stats {vars(stats)}; launches {counts} (paged attention: calls, two launches each); "
          f"flash routes {routes}")
    if not all(r.done for r in eng.requests.values()):
        raise AssertionError("not every request finished")
    if min(stats.parks, stats.evicted_pages, stats.compactions) <= 0:
        raise AssertionError("the run must park, evict and compact")
    if min(counts[name] for name in SERVING_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    if counts != EXPECTED_LAUNCHES[full.name]:
        raise AssertionError(f"launch counts {counts} differ from {EXPECTED_LAUNCHES[full.name]}")
    if routes["tensor_core"] != counts["flash_attention"]:
        raise AssertionError(f"a flash attention call of the run missed the tensor-core route: {routes}")

    # the policy depends on lengths only: the reduced CPU run agrees
    rspec = ModelSpec(reduced)
    rparams = rspec.init(torch.Generator().manual_seed(SEED), device="cpu")
    _, rstats, _ = run_engine(rspec, rparams, reduced.vocab, "cpu")
    if vars(rstats) != vars(stats):
        raise AssertionError(f"ServeStats differ from the reduced CPU run: {vars(rstats)}")
    print("  ServeStats equal the reduced-width CPU run")

    outs = {rid: eng.requests[rid].out for rid in prompts}
    dense, dt_base = baseline_serve(spec, params, prompts, NEW_TOKENS, device="cuda")
    exact = sum(a == b for rid in prompts for a, b in zip(outs[rid], dense[rid]))
    total = len(prompts) * NEW_TOKENS
    if moe:
        # the reference: the engine's own batches over dense KV caches, first
        # with the tokens forced, then with the tokens and the routing forced
        n_sets = sum(int((r >= 0).sum()) for _, r in batches) * full.n_layers
        with patched(layers, "moe_route", routing_recorder(kv.batch, routes_replay)):
            gaps = replay_dense(spec, params, prompts, batches, outs, device="cuda")
        if len(routes_tiered) != len(routes_replay) or len(routes_tiered) != len(batches) * full.n_layers:
            raise AssertionError(f"routing records: {len(routes_tiered)} tiered, {len(routes_replay)} replayed")
        differ, first, _ = routing_disagreement(routes_tiered, routes_replay, batches, full.n_layers)
        print(f"  replay of the tokens: worst gap to its max logit {max(max(g) for g in gaps.values()):.4f}; "
              f"(step, layer, row) top-k sets that differ from its own: {differ} of {n_sets}, the first at "
              f"(step, layer) {first}")
        routes_forced = []
        with patched(layers, "moe_route", routing_recorder(kv.batch, routes_forced)):
            gaps = replay_dense(spec, params, prompts, batches, outs, device="cuda",
                                routes=[idx for _, idx in routes_tiered])
        worst = max(max(g) for g in gaps.values())
        differ, _, deficit = routing_disagreement(routes_tiered, routes_forced, batches, full.n_layers)
        print(f"  replay of the tokens and routes: worst gap to its max logit {worst:.4f} (tol {NEAR_TIE_MOE}); "
              f"{differ} of {n_sets} forced top-k sets are not its router's own, the farthest choice "
              f"{deficit:.4f} below its k-th logit (tol {ROUTE_TIE}); exact-match rate vs batch-1 dense greedy "
              f"(information) {exact}/{total} = {exact / total:.3f}")
        if worst > NEAR_TIE_MOE:
            raise AssertionError(f"an emitted token is {worst} below the forced replay's max logit")
        if deficit > ROUTE_TIE:
            raise AssertionError(f"a routed expert lies {deficit} below the replay router's k-th logit")
    else:
        worst = 0.0
        for rid, p in prompts.items():
            _, gaps = dense_decode(spec, params, p, NEW_TOKENS, forced=outs[rid], device="cuda")
            worst = max(worst, max(gaps))
        print(f"  near-tie check: worst gap to the dense max logit {worst:.4f} (tol {NEAR_TIE}); "
              f"exact-match rate vs dense greedy {exact}/{total} = {exact / total:.3f}")
        if worst > NEAR_TIE:
            raise AssertionError(f"an emitted token is {worst} below the dense decode's max logit")
    base_total = sum(len(o) for o in dense.values())
    print(f"  tok/s skybyte {stats.decoded_tokens / dt:.1f} ({stats.decoded_tokens} tokens in {dt:.3f}s); "
          f"baseline {base_total / dt_base:.1f} ({base_total} tokens in {dt_base:.3f}s) — on {card}")

    # where a decode step's time goes: a separate run; 4 steps timed without
    # the profiler, then 4 traced (the trace stays out of the tok/s above)
    eng = TieredEngine(spec, params, kv, device="cuda")
    for rid, p in prompts.items():
        eng.add_request(Request(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
    for _ in range(8):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 4 * 1e3
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name):  # the MoE's phases as profiler ranges, in this window only
        def wrap(fn):
            def run(*args, **kw):
                with record_function(name):
                    return fn(*args, **kw)
            return run
        return wrap

    with contextlib.ExitStack() as stack:
        if moe:
            for name in MOE_PHASES:
                stack.enter_context(patched(layers, name, ranged(name)))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                eng.step()
            torch.cuda.synchronize()
    events = prof.events()
    # kernels and copies on the card (the ranges' own device-side spans are not ops)
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in MOE_PHASES]
    busy_ms = union_ms(on_device) / 4
    by_name = {}
    for e in on_device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 4e3
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:8]
    paged_ms = union_ms([e for e in on_device if "paged_split_kernel" in e.name or "paged_combine_kernel" in e.name]) / 4
    sum_ms = sum(e.time_range.elapsed_us() for e in on_device) / 4e3
    append = [e for e in on_device if "kv_log_append_kernel" in e.name]
    append_ms = sum(e.time_range.elapsed_us() for e in append) / 4e3
    print(f"  kv_log_append (fused epilogue) {append_ms:.4f} ms/step in {len(append) / 4:.0f} launches "
          f"({append_ms / max(len(append) / 4, 1) * 1e3:.2f} us a layer)")
    print(f"  decode step (untraced) {step_ms:.2f} ms; device busy {busy_ms:.3f} ms/step "
          f"(sum of kernel times {sum_ms:.3f}; {len(on_device) / 4:.0f} device ops/step); idle share {1 - busy_ms / step_ms:.3f}; "
          f"paged attention {paged_ms:.4f} ms/step — on {card}")
    if moe:
        phase_ms, phase_ops, unlinked = launched_in(events, MOE_PHASES)
        moe_ms = sum(phase_ms.values()) / 4
        print(f"  MoE {moe_ms:.3f} ms/step of device time ({moe_ms / busy_ms:.3f} of busy), by the ops launched "
              f"inside each phase: " + ", ".join(f"{name} {ms / 4:.4f} ({phase_ops[name] / 4:.0f} ops)"
                                                 for name, ms in phase_ms.items())
              + f"; {unlinked} device ops of the window linked to no launch")
        weights = sum(t.numel() * t.element_size() for t in params.values())
        print(f"  weights {weights / 1e9:.3f} GB, read once a step: {weights / PEAK_BYTES * 1e3:.3f} ms at "
              f"{PEAK_BYTES / 1e12:.2f} TB/s")
    for name, ms in top:
        print(f"    {ms:8.4f} ms/step  {name[:90]}")
    return counts, routes


def check_flash_backward(shapes=FLASH_BWD_SHAPES):
    """Phase 7 (a): flash attention's forward and backward (the wrapper's
    autograd node: ``flash_attention_bwd``) against the plain version and
    its autograd at ``shapes``, with the backward's times, the plain
    version's and sdpa's backward. Each of dq, dk, dv passes TOL's allclose
    and lies within TOL_BWD_REL of its max |value|."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for name, B, S, S_kv, H, KV, hd, causal in shapes:
        def leaf(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16).requires_grad_(True)

        q, k, v = leaf(B, S, H, hd), leaf(B, S_kv, KV, hd), leaf(B, S_kv, KV, hd)
        dout = torch.randn((B, S, H, hd), generator=gen, device=dev).to(torch.bfloat16)
        out = flash_attention(q, k, v, causal=causal)
        if out.grad_fn is None:
            raise AssertionError("flash attention's output on the card has no autograd node")
        got = torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
        out_ref = flash_attention_ref(q, k, v, causal=causal)
        check_close(f"flash attention {name}", out, out_ref, TOL["flash_attention"])
        want = torch.autograd.grad(out_ref, (q, k, v), dout, retain_graph=True)
        err = max(check_close(f"flash backward {name} d{x}", a, b, TOL["flash_attention"])
                  for x, a, b in zip("qkv", got, want))
        rel = 0.0
        for x, a, b in zip("qkv", got, want):
            r = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
            if not r <= TOL_BWD_REL:
                raise AssertionError(f"flash backward {name} d{x}: max abs err {r:.3g} of max |value| "
                                     f"(tol {TOL_BWD_REL})")
            rel = max(rel, r)
        g = H // KV
        qt = q.detach().transpose(1, 2).requires_grad_(True)
        kt, vt = (t.detach().repeat_interleave(g, 2).transpose(1, 2).requires_grad_(True) for t in (k, v))
        out_s, dout_t = sdpa(qt, kt, vt, is_causal=causal), dout.transpose(1, 2)
        pairs = S * (S + 1) // 2 - max(S - S_kv, 0) * (S - S_kv + 1) // 2 if causal else S * S_kv
        nbytes = 2 * (4 * q.numel() + 4 * k.numel())  # read q, k, v, o, dO; write dq, dk, dv (bf16)
        rows.append(dict(shape=f"{name}: B={B} S={S} S_kv={S_kv} H={H} KV={KV} hd={hd} "
                               f"{'causal' if causal else 'non-causal'}", **timed(
            lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True),
            lambda: torch.autograd.grad(out_ref, (q, k, v), dout, retain_graph=True),
            lambda: torch.autograd.grad(out_s, (qt, kt, vt), dout_t, retain_graph=True), err,
            bound_ms(nbytes, 2.5 * 4.0 * B * H * hd * pairs), device=window_ms,
        ), max_rel_err=rel))
        del out, out_ref, out_s, got, want
        torch.cuda.empty_cache()
    for r in rows:
        lib_dev = "not measured" if r["library_device_ms"] is None else f"{r['library_device_ms']:.4f}"
        print(f"  flash backward {r['shape']}: err {r['max_abs_err']:.3g} (tol {TOL['flash_attention']}), "
              f"{r['max_rel_err']:.3g} of max (tol {TOL_BWD_REL})  "
              f"wrapper {r['ms']:.4f} ms (device {r['device_ms']:.4f}, {r['device_ops']:.1f} ops)  plain "
              f"{r['plain_ms']:.4f} ms (device {r['plain_device_ms']:.4f})  sdpa backward {r['library_ms']:.4f} ms "
              f"(device {lib_dev})  bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return rows


def train(card):
    """Phase 7 (b): full-width qwen3-1.7b through ``build_train_step``.
    Returns (flash launches of the training run, its routes, step 0: its
    metrics, the updated bf16 params and mu in bf16, on the host)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import OptimConfig, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.steps import build_train_step, make_train_state
    from repro_torch.models import dense
    from repro_torch.models.api import ModelSpec
    from repro_torch.optim.adamw import global_norm

    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    spec = ModelSpec(cfg)
    n_params = spec.param_count()
    tokens = TRAIN_SEQ * TRAIN_BATCH
    optim = OptimConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=TRAIN_STEPS + 1)
    plain_step = build_train_step(spec, optim, TRAIN_ACCUM)
    compress_step = build_train_step(spec, dataclasses.replace(optim, compress_grads=True), TRAIN_ACCUM)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(spec, torch.Generator(device=dev).manual_seed(SEED), compress=True, device=dev)
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(i).items()}

    print(f"  config {cfg.name}: {n_params / 1e9:.3f} B params; seq {TRAIN_SEQ}, global batch {TRAIN_BATCH}, "
          f"{TRAIN_ACCUM} microbatches, remat; {optim}")
    # the reference: step 0's loss, grad norm and attention-projection grads
    # with the plain attention
    with patched(dense, "flash_attention", lambda _: flash_attention_ref):
        reset_launch_counts()
        grads, loss = plain_step.grads_and_loss(state["params"], batch_at(0))
        ref_loss, ref_gnorm = float(loss), float(global_norm(grads))
        ref_attn = {n: grads[n] for n in TRAIN_ATTN_LEAVES}
        if launch_counts()["flash_attention"]:
            raise AssertionError("the plain-attention step launched the flash kernel")
        del grads, loss
    torch.cuda.empty_cache()
    # the same gradients through the kernel and its backward, leaf by leaf
    grads, _ = plain_step.grads_and_loss(state["params"], batch_at(0))
    for n in TRAIN_ATTN_LEAVES:
        scale = ref_attn[n].abs().max().item()
        rel = (grads[n] - ref_attn[n]).abs().max().item() / scale
        print(f"  step 0 {n} gradient, kernel vs plain attention: max abs err {rel:.3g} of max {scale:.3g} "
              f"(tol {TRAIN_LEAF_TOL})")
        if not (scale > 0 and rel <= TRAIN_LEAF_TOL):
            raise AssertionError(f"step 0: the kernel's {n} gradient is not the plain-attention step's")
    del grads, ref_attn
    torch.cuda.empty_cache()

    def bits_equal_master():
        with torch.no_grad():
            return all(torch.equal(p, state["opt"].master[n].to(torch.bfloat16)) for n, p in state["params"].items())

    losses, gnorms, times = [], [], []
    reset_launch_counts()
    for i in range(TRAIN_STEPS):
        step_fn = compress_step if i == 1 else plain_step
        batch = batch_at(i)
        before = launch_counts()["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
        n_flash = launch_counts()["flash_attention"] - before
        print(f"  step {i}{' (compressed)' if i == 1 else ''}: loss {m['loss']:.5f} grad_norm {m['grad_norm']:.5f} "
              f"lr {m['lr']:.3e} step {int(m['step'])}; {times[-1] * 1e3:.1f} ms; flash launches {n_flash}")
        if n_flash != TRAIN_FLASH_PER_STEP:
            raise AssertionError(f"step {i}: {n_flash} flash launches, want {TRAIN_FLASH_PER_STEP}")
        if not bits_equal_master():
            raise AssertionError(f"step {i}: params are not bf16(master)")
        if i == 0:
            step0 = {"metrics": {k: v.item() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()},
                     "params": {n: p.detach().to("cpu") for n, p in state["params"].items()},
                     "mu": {n: m.to("cpu", torch.bfloat16) for n, m in state["opt"].mu.items()}}
            dl, dg = abs(m["loss"] - ref_loss) / ref_loss, abs(m["grad_norm"] - ref_gnorm) / ref_gnorm
            print(f"  plain-attention step 0: loss {ref_loss:.5f} grad_norm {ref_gnorm:.5f}; relative gap loss "
                  f"{dl:.3g} (tol {TRAIN_LOSS_RTOL}), grad_norm {dg:.3g} (tol {TRAIN_GNORM_RTOL})")
            if dl > TRAIN_LOSS_RTOL or dg > TRAIN_GNORM_RTOL:
                raise AssertionError("the kernel's step 0 is not the plain-attention step's")
    counts, routes = launch_counts(), route_counts()
    want = {name: 0 for name in counts}
    want["flash_attention"] = TRAIN_FLASH_PER_STEP * TRAIN_STEPS
    if counts != want or routes != {"tensor_core": want["flash_attention"], "cuda_core": 0}:
        raise AssertionError(f"training launches {counts}, routes {routes}; want {want}, all tensor-core")

    # one more step under the profiler: device busy, idle share, and the
    # device time of the attention backward and of AdamW (profiler ranges)
    from torch.profiler import record_function

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import steps

    def ranged(name):
        def wrap(fn):
            def run(*args, **kw):
                with record_function(name):
                    return fn(*args, **kw)
            return run
        return wrap

    batch = batch_at(TRAIN_STEPS)
    with patched(flash_ops, "flash_attention_bwd", ranged(TRAIN_PARTS[0])), \
            patched(steps, "adamw_update", ranged(TRAIN_PARTS[1])):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, metrics = plain_step(state, batch)
            torch.cuda.synchronize()
    losses.append(float(metrics["loss"]))
    events = prof.events()
    part_ms = {name: sum(e.device_time_total for e in events
                         if e.device_type == torch.autograd.DeviceType.CPU and e.name == name) / 1e3
               for name in TRAIN_PARTS}
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in TRAIN_PARTS]
    if not on_device:
        raise AssertionError("the profiler saw no device op in the training step")
    busy_ms = union_ms(on_device)
    by_name = {}
    for e in on_device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite, or the last is not below the first")
    step_s = float(np.mean(times[2:]))  # steady steps without compression
    print(f"  losses {[round(x, 5) for x in losses]} (the last profiled)")
    print(f"  train step (steps 2-{TRAIN_STEPS - 1}, untraced) {step_s * 1e3:.1f} ms; {tokens / step_s:.0f} tokens/s; "
          f"model-FLOP share 6 N tokens / (step s x 989e12) = {6 * n_params * tokens / (step_s * PEAK_BF16):.4f}; "
          f"compressed step {times[1] * 1e3:.1f} ms — on {card}")
    print(f"  profiled step: device busy {busy_ms:.1f} ms ({len(on_device)} device ops); idle share "
          f"{1 - busy_ms / (step_s * 1e3):.3f} of the untraced step; device ms by part: "
          + ", ".join(f"{name} {ms:.1f}" for name, ms in part_ms.items())
          + f", the rest (model forward, remat, backward; loss) {busy_ms - sum(part_ms.values()):.1f}")
    print(f"  peak memory {peak / 1e9:.2f} GB (max_memory_allocated; budget ~55 GB: bf16 params 4.1, fp32 "
          f"master/mu/nu 24.4, gradient sum 8.1, residual 8.1, bf16 .grad 4.1, fp32 logits ~2.5 a copy)")
    for name, ms in sorted(by_name.items(), key=lambda kv_: -kv_[1])[:8]:
        print(f"    {ms:9.3f} ms  {name[:90]}")
    return counts, routes, step0


def digest(params) -> int:
    """A checksum of bf16 params on the host: the sum of their 16-bit
    patterns, each weighted by its leaf's place in sorted order."""
    return sum((i + 1) * int(params[n].view(torch.int16).sum(dtype=torch.int64)) for i, n in enumerate(sorted(params)))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def distribution(card, step0):
    """Phase 8: phase 7's step 0 through the sharded step on a 1 x 1 mesh
    over a one-rank NCCL group. Returns (its kernel launches, routes)."""
    import torch.distributed as dist

    from repro_torch.configs import OptimConfig, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.launch.dryrun import cell_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step, shard_train_state
    from repro_torch.models.api import ModelSpec
    from repro_torch.optim.adamw import adamw_init

    dev = torch.device("cuda", 0)
    cfg = get_config(TRAIN_ARCH)
    spec = ModelSpec(cfg)
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    optim = OptimConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=TRAIN_STEPS + 1)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_host_mesh("cuda")
        # phase 7's state from its seed: the params drawn on the card, the
        # rest built on the host, so that the card holds only what
        # shard_train_state places there
        params = {n: p.cpu() for n, p in spec.init(torch.Generator(device=dev).manual_seed(SEED), device=dev).items()}
        host = {"params": params, "opt": adamw_init(params),
                "residual": {n: torch.zeros(p.shape, dtype=torch.float32) for n, p in params.items()}}
        torch.cuda.empty_cache()
        dry = cell_bytes(TRAIN_ARCH, "train_4k", {"data": 1, "model": 1})["bytes"]
        want = dry["state"] + dry["residual"]
        before = torch.cuda.memory_allocated()
        state = shard_train_state(spec, host, mesh)
        grown = torch.cuda.memory_allocated() - before
        del host, params
        gap = abs(grown - want) / want
        print(f"  dry run, {TRAIN_ARCH} on 1 x 1: state {dry['state'] / 1e9:.3f} GB + residual {dry['residual'] / 1e9:.3f}"
              f" GB = {want / 1e9:.3f} GB a device; the card's allocation grew {grown / 1e9:.3f} GB over "
              f"shard_train_state: gap {gap:.2e} (tol {DRYRUN_MEM_RTOL})")
        if gap > DRYRUN_MEM_RTOL:
            raise AssertionError("the dry run's state bytes are not the card's allocation")
        step = build_train_step(spec, optim, TRAIN_ACCUM, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times = []
        for i in range(2):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(i).items()}
            before_flash = launch_counts()["flash_attention"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            m = {k: v.item() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
            n_flash = launch_counts()["flash_attention"] - before_flash
            print(f"  sharded step {i}: loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f} step {int(m['step'])}; "
                  f"{times[-1] * 1e3:.1f} ms; flash launches {n_flash}")
            if n_flash != TRAIN_FLASH_PER_STEP:
                raise AssertionError(f"sharded step {i}: {n_flash} flash launches, want {TRAIN_FLASH_PER_STEP}")
            if i == 0:
                got = {n: p.to_local().detach().to("cpu") for n, p in state["params"].items()}
                want_m = step0["metrics"]
                same = {k: m[k] == want_m[k] for k in ("loss", "grad_norm", "lr", "step")}
                leaves_equal = {n: torch.equal(got[n], step0["params"][n]) for n in got}
                print(f"  phase 7 step 0: loss {want_m['loss']:.6f} grad_norm {want_m['grad_norm']:.6f}; "
                      f"bit-equal {same}; bf16 params bit-equal in {sum(leaves_equal.values())} of {len(got)} leaves; "
                      f"checksum {digest(got)} (phase 7: {digest(step0['params'])})")
                if not all(same.values()) or not all(leaves_equal.values()):
                    for n, eq in leaves_equal.items():
                        if not eq:
                            d = (got[n].float() - step0["params"][n].float()).abs()
                            print(f"    {n}: {int((d > 0).sum())} elements differ, max {float(d.max()):.3g}")
                    raise AssertionError("the sharded step on 1 x 1 is not phase 7's step 0 bit for bit")
                del got
        peak = torch.cuda.max_memory_allocated()
        counts, routes = launch_counts(), route_counts()
        want_counts = {name: 0 for name in counts}
        want_counts["flash_attention"] = 2 * TRAIN_FLASH_PER_STEP
        if counts != want_counts or routes != {"tensor_core": want_counts["flash_attention"], "cuda_core": 0}:
            raise AssertionError(f"sharded launches {counts}, routes {routes}; want {want_counts}, all tensor-core")
        print(f"  sharded train step (step 1, untraced) {times[1] * 1e3:.1f} ms, step 0 {times[0] * 1e3:.1f} ms "
              f"(its first collectives included); {TRAIN_SEQ * TRAIN_BATCH / times[1]:.0f} tokens/s; peak memory "
              f"{peak / 1e9:.2f} GB (max_memory_allocated) — on {card}")
        del state
    finally:
        dist.destroy_process_group()
    return counts, routes


def split_rank(rank: int, port: int, ref, queue) -> None:
    """One rank of phase 9 (a spawned process on device 0): phase 7's state
    on the (1, 2) mesh, step 0 (rank 0's under the profiler) and a
    compressed step 1. ``ref``: phase 7's step-0 params and mu on the card
    (CUDA IPC). Puts its numbers on ``queue``; raises on a failure, which
    fails the phase."""
    import dataclasses
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import OptimConfig, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import sharding
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.launch.steps import build_train_step, shard_train_state
    from repro_torch.models import dense
    from repro_torch.models.api import ModelSpec
    from repro_torch.models.common import flat_leaves
    from repro_torch.optim.adamw import adamw_init

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=SPLIT_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cuda", SPLIT_MESH, mesh_dim_names=("data", "model"))
        cfg = get_config(TRAIN_ARCH)
        spec = ModelSpec(cfg)
        sums = {name for name, leaf in flat_leaves(spec.schema()) if sum(a != "layers" for a in leaf.axes) <= 1}
        data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
        optim = OptimConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=TRAIN_STEPS + 1)
        params = {n: p.cpu() for n, p in spec.init(torch.Generator(device=dev).manual_seed(SEED), device=dev).items()}
        host = {"params": params, "opt": adamw_init(params),
                "residual": {n: torch.zeros(p.shape, dtype=torch.float32) for n, p in params.items()}}
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        state = shard_train_state(spec, host, mesh)
        out = {"rank": rank, "grown": torch.cuda.memory_allocated() - before, "steps": []}
        del host, params
        steps = [build_train_step(spec, optim, TRAIN_ACCUM, mesh=mesh),
                 build_train_step(spec, dataclasses.replace(optim, compress_grads=True), TRAIN_ACCUM, mesh=mesh)]
        shapes = {}

        def recording(q, k, v, *, causal=True):
            key = f"{tuple(q.shape)} / KV {k.shape[2]}"
            shapes[key] = shapes.get(key, 0) + 1
            return flash(q, k, v, causal=causal)

        flash, dense.flash_attention = dense.flash_attention, recording
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        sizes, coord = sharding.mesh_shape(mesh), sharding.mesh_coordinate(mesh)
        for i, step in enumerate(steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(i).items()}
            flash_before, tc_before = launch_counts()["flash_attention"], route_counts()["tensor_core"]
            traced = i == 0 and rank == 0
            dist.barrier()  # both ranks start the step together (rank 0 reads its profile after step 0)
            with profile(activities=[ProfilerActivity.CUDA]) if traced \
                    else contextlib.nullcontext() as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            out["steps"].append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                                 "ms": ms, "flash": launch_counts()["flash_attention"] - flash_before,
                                 "tensor_core": route_counts()["tensor_core"] - tc_before})
            if traced:  # this rank's kernels on the card (rank 1's share it)
                on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                             and not e.name.startswith("gloo:")]  # not gloo's annotations of its copies
                if not on_device:
                    raise AssertionError("the profiler saw no device op in the split step")
                by_name = {}
                for e in on_device:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
                copies = [e for e in on_device if e.name.startswith("Memcpy")]
                out["profile"] = {"busy_ms": union_ms(on_device), "device_ops": len(on_device),
                                  "copies_ms": union_ms(copies) if copies else 0.0, "copies": len(copies),
                                  "top": sorted(by_name.items(), key=lambda kv_: -kv_[1])[:6]}
            if i == 0:  # this rank's shards against phase 7's step 0; each element counted on its first replica
                mu_gaps, ulps, excess, held, differ, total = {}, 0, 0.0, 0, 0, 0
                for name, p in state["params"].items():
                    spec_ = sharding.spec_of(p)
                    sl = sharding.shard_slices(ref["params"][name].shape, spec_, sizes, coord)
                    mine, want = sharding.local(p).detach(), ref["params"][name][sl]
                    mine_mu, want_mu = sharding.local(state["opt"].mu[name]), ref["mu"][name][sl].float()
                    scale = float(ref["mu"][name].float().abs().max())
                    mu_gaps[name] = float((mine_mu - want_mu).abs().max()) / max(scale, 1e-30)
                    same = (torch.sign(mine_mu) == torch.sign(want_mu)) & \
                        (torch.minimum(mine_mu.abs(), want_mu.abs()) > SPLIT_MU_FLOOR)
                    if same.any():
                        a, b = mine[same], want[same]
                        ulps = max(ulps, bf16_ulps(a, b))
                        a, b = a.float(), b.float()
                        ulp = torch.ldexp(torch.ones_like(a), torch.frexp(torch.maximum(a.abs(), b.abs())).exponent - 8)
                        excess = max(excess, float(((a - b).abs() / (SPLIT_ULPS * ulp + SPLIT_MASTER_ABS)).max()))
                        del a, b, ulp
                    if sharding.is_first_replica(spec_, sizes, coord):
                        held += int(same.sum())
                        differ += int((mine != want).sum())
                        total += mine.numel()
                out.update(mu_gaps=mu_gaps, mu_tols={n: SPLIT_MU_TOL_SUMS if n in sums else SPLIT_MU_TOL
                                                     for n in mu_gaps},
                           ulps=ulps, excess=excess, held=held, differ=differ, elements=total)
        out["peak"] = torch.cuda.max_memory_allocated()
        out["shapes"] = shapes
        out["launches"] = launch_counts()
        out["routes"] = route_counts()
        queue.put(out)
    finally:
        dist.destroy_process_group()


def split_training(card, step0):
    """Phase 9: phase 7's step 0 through the split step on (1, 2), two
    ranks on the one card over gloo. Returns (flash launches summed over
    the ranks, tensor-core launches, each rank's results)."""
    import torch.multiprocessing as mp

    from repro_torch.launch.dryrun import cell_bytes

    dry = cell_bytes(TRAIN_ARCH, "train_4k", dict(zip(("data", "model"), SPLIT_MESH)))
    want_bytes = dry["bytes"]["state"] + dry["bytes"]["residual"]
    ref = {part: {n: t.to("cuda") for n, t in step0[part].items()} for part in ("params", "mu")}
    queue = mp.get_context("spawn").SimpleQueue()
    t0 = time.perf_counter()
    mp.spawn(split_rank, args=(free_port(), ref, queue), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = sorted((queue.get() for _ in range(2)), key=lambda r: r["rank"])
    del ref
    torch.cuda.ipc_collect()  # the blocks the ranks held through CUDA IPC
    torch.cuda.empty_cache()
    want_m = step0["metrics"]
    print(f"  two ranks on {card}, gloo with CUDA tensors, mesh (data 1, model 2); {wall:.1f} s with the ranks' start")
    per_step = TRAIN_FLASH_PER_STEP
    for r in ranks:
        gap = abs(r["grown"] - want_bytes) / want_bytes
        s0, s1 = r["steps"]
        dl = abs(s0["loss"] - want_m["loss"]) / want_m["loss"]
        dg = abs(s0["grad_norm"] - want_m["grad_norm"]) / want_m["grad_norm"]
        print(f"  rank {r['rank']}: dry run {want_bytes / 1e9:.3f} GB state + residual a device, allocation grew "
              f"{r['grown'] / 1e9:.3f} GB: gap {gap:.2e} (tol {DRYRUN_MEM_RTOL})")
        worst = sorted(r["mu_gaps"], key=lambda n: -r["mu_gaps"][n] / r["mu_tols"][n])[:4]
        print(f"  rank {r['rank']}: step 0 loss {s0['loss']:.6f} grad_norm {s0['grad_norm']:.6f} (phase 7: "
              f"{want_m['loss']:.6f} {want_m['grad_norm']:.6f}; gaps {dl:.3g} (tol {SPLIT_LOSS_RTOL}), {dg:.3g} "
              f"(tol {SPLIT_GNORM_RTOL})); mu of each leaf against phase 7's, of its max (tol {SPLIT_MU_TOL}, "
              f"gains and biases {SPLIT_MU_TOL_SUMS}), the largest: "
              + ", ".join(f"{n} {r['mu_gaps'][n]:.3g}" for n in worst))
        print(f"  rank {r['rank']}: bf16 params: {r['differ']} of {r['elements']} elements differ from phase 7's; "
              f"where mu agrees in sign above {SPLIT_MU_FLOOR} ({r['held']} elements) the largest gap "
              f"{r['excess']:.3f} of its allowance ({SPLIT_ULPS} ulps + {SPLIT_MASTER_ABS:g}), {r['ulps']} ulps "
              f"at most")
        if "profile" in r:
            p = r["profile"]
            print(f"  rank {r['rank']}: profiled step 0: its device ops busy {p['busy_ms']:.1f} ms of {s0['ms']:.1f} "
                  f"({p['device_ops']} ops, of which gloo's {p['copies']} device-host copies {p['copies_ms']:.1f} ms; "
                  f"idle share {1 - p['busy_ms'] / s0['ms']:.3f}: gloo's host staging and waits, and rank 1's "
                  f"kernels on the same card); by name: "
                  + ", ".join(f"{name[:48]} {ms:.1f}" for name, ms in p["top"]))
        print(f"  rank {r['rank']}: step 0 {s0['ms']:.1f} ms{' (profiled)' if 'profile' in r else ''}, step 1 "
              f"(compressed) {s1['ms']:.1f} ms, loss "
              f"{s1['loss']:.6f} — gloo stages every collective through the host: host staging, not TP over "
              f"NVLink; flash launches {s0['flash']} + {s1['flash']} at {r['shapes']}; peak "
              f"{r['peak'] / 1e9:.2f} GB (limit {SPLIT_PEAK_LIMIT / 1e9:.2f}) — on {card}")
        if gap > DRYRUN_MEM_RTOL:
            raise AssertionError(f"rank {r['rank']}: the dry run's state bytes are not the card's allocation")
        if dl > SPLIT_LOSS_RTOL or dg > SPLIT_GNORM_RTOL:
            raise AssertionError(f"rank {r['rank']}: the split step 0's loss or grad norm is not phase 7's")
        off = {n: g for n, g in r["mu_gaps"].items() if not g <= r["mu_tols"][n]}
        if off:
            raise AssertionError(f"rank {r['rank']}: the split step 0's mu is not phase 7's in {off}")
        if not (r["excess"] <= 1.0 and r["held"]):
            raise AssertionError(f"rank {r['rank']}: where mu agrees the params are {r['excess']:.3f} of their "
                                 f"allowance from phase 7's ({r['held']} elements held)")
        want_shape = f"{(1, TRAIN_SEQ, FLASH_SPLIT_SHAPE[4], 128)} / KV {FLASH_SPLIT_SHAPE[5]}"
        if any(x["flash"] != per_step or x["tensor_core"] != per_step for x in r["steps"]) or \
                r["shapes"] != {want_shape: 2 * per_step}:
            raise AssertionError(f"rank {r['rank']}: flash launches {r['steps']}, shapes {r['shapes']}; want "
                                 f"{per_step} a step, all tensor-core, at {want_shape}")
        if not r["peak"] < SPLIT_PEAK_LIMIT:
            raise AssertionError(f"rank {r['rank']}: peak {r['peak'] / 1e9:.2f} GB is not below phase 8's")
        if not np.isfinite([s0["loss"], s1["loss"]]).all():
            raise AssertionError(f"rank {r['rank']}: losses not finite")
        if any(n for name, n in r["launches"].items() if name != "flash_attention"):
            raise AssertionError(f"rank {r['rank']}: the split step launched other kernels: {r['launches']}")
    return (sum(r["launches"]["flash_attention"] for r in ranks), sum(r["routes"]["tensor_core"] for r in ranks),
            ranks)


def serve_run(spec, params, prompt, mesh=None, frontend=None, new=FAMILY_NEW):
    """Prefill, then ``new`` - 1 greedy decode steps through the step
    builders (sharded on ``mesh``, or unsharded), the cache at
    SERVE_MAX_LEN. Returns (tokens (B, ``new``), each step's logits as
    the steps' greedy is given them, prefill ms, decode ms a step)."""
    from repro_torch.launch import steps

    logits, inner = [], steps.greedy

    def recording(lg, vocab=None, rows=None):
        logits.append(lg.float())
        return inner(lg, vocab, rows)

    B, S = prompt.shape
    steps.greedy = recording
    try:
        prefill_step, serve_step = steps.build_prefill_step(spec, mesh), steps.build_serve_step(spec, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = prefill_step(params, prompt, frontend)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dc = steps.decode_cache(spec, cache, B, SERVE_MAX_LEN, device=prompt.device, mesh=mesh)
        del cache
        toks = [tok]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for i in range(new - 1):
            tok, dc = serve_step(params, dc, tok, S + i)
            toks.append(tok)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        steps.greedy = inner
    return torch.cat(toks, dim=1), logits, (t1 - t0) * 1e3, (t3 - t2) / (new - 1) * 1e3


def serve_rank(rank: int, port: int, queue) -> None:
    """One rank of phase 10 (b) (a spawned process on device 0): the seed's
    params placed on the (1, 2) mesh, a warm-up prefill and decode step,
    then the served run with the launch counts set to 0 before it. Puts its
    numbers on ``queue``."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.launch.steps import build_prefill_step, build_serve_step, decode_cache
    from repro_torch.models import dense
    from repro_torch.models.api import ModelSpec

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=SPLIT_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cuda", SERVE_MESH, mesh_dim_names=("data", "model"))
        spec = ModelSpec(get_config(SERVE_ARCH))
        whole = spec.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
        params = sharding.shard_params(spec, whole, mesh)
        del whole
        torch.cuda.empty_cache()
        prompt = family_inputs(spec.cfg, dev)[0]
        B, S = prompt.shape
        tok, cache = build_prefill_step(spec, mesh)(params, prompt)  # warm-up: first calls, gloo's buffers
        build_serve_step(spec, mesh)(params, decode_cache(spec, cache, B, SERVE_MAX_LEN, mesh=mesh), tok, S)
        del cache
        shapes = {}

        def recording(q, k, v, *, causal=True):
            key = f"{tuple(q.shape)} / KV {k.shape[2]}"
            shapes[key] = shapes.get(key, 0) + 1
            return flash(q, k, v, causal=causal)

        flash, dense.flash_attention = dense.flash_attention, recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_launch_counts()
        t0 = time.perf_counter()
        tok, cache = build_prefill_step(spec, mesh)(params, prompt)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = dict(launch_counts())
        before = torch.cuda.memory_allocated()
        dc = decode_cache(spec, cache, B, SERVE_MAX_LEN, mesh=mesh)
        grown = torch.cuda.memory_allocated() - before
        del cache
        serve_step, toks = build_serve_step(spec, mesh), [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(FAMILY_NEW - 1):
            tok, dc = serve_step(params, dc, tok, S + i)
            toks.append(tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / (FAMILY_NEW - 1) * 1e3
        dense.flash_attention = flash
        queue.put({"rank": rank, "tokens": torch.cat(toks, dim=1).cpu().numpy(), "prefill_ms": prefill_ms,
                   "decode_ms": decode_ms, "grown": grown, "local_shape": tuple(sharding.local(dc["k"]).shape),
                   "peak": torch.cuda.max_memory_allocated(), "prefill_launches": prefill_launches,
                   "launches": launch_counts(), "routes": route_counts(), "shapes": shapes})
    finally:
        dist.destroy_process_group()


def sharded_serving(card):
    """Phase 10: full-width qwen3-1.7b through the sharded prefill and
    decode steps: (a) the unsharded reference, (c) 1 x 1 over NCCL, (b)
    (1, 2) as two ranks on the card over gloo. Returns ((c)'s launch
    counts and routes, (b)'s ranks)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.launch.dryrun import cache_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import decode_cache
    from repro_torch.models.api import ModelSpec

    dev = torch.device("cuda", 0)
    cfg = get_config(SERVE_ARCH)
    spec = ModelSpec(cfg)
    params = spec.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompt = family_inputs(cfg, dev)[0]
    B, S = prompt.shape
    print(f"  {SERVE_ARCH}: {B} prompts of {S} tokens, {FAMILY_NEW} tokens each, cache max_len {SERVE_MAX_LEN}")
    # (a) the reference
    ref_tokens, ref_logits, ref_prefill, ref_decode = serve_run(spec, params, prompt)
    print(f"  (a) unsharded steps: prefill {ref_prefill:.1f} ms, decode {ref_decode:.2f} ms a step, "
          f"{B / ref_decode * 1e3:.1f} tok/s — on {card}")
    # (c) 1 x 1 over a one-rank NCCL group: bit for bit
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_host_mesh("cuda")
        sharded = sharding.shard_params(spec, params, mesh)
        reset_launch_counts()
        tokens_1x1, logits_1x1, prefill_1x1, decode_1x1 = serve_run(spec, sharded, prompt, mesh)
        counts_1x1, routes_1x1 = launch_counts(), route_counts()
        del sharded
    finally:
        dist.destroy_process_group()
    same = torch.equal(tokens_1x1, ref_tokens) and len(logits_1x1) == len(ref_logits) and \
        all(torch.equal(a, b) for a, b in zip(logits_1x1, ref_logits))
    print(f"  (c) 1 x 1 over NCCL: tokens and every step's logits bit-equal to (a): {same}; prefill "
          f"{prefill_1x1:.1f} ms, decode {decode_1x1:.2f} ms a step; launches {counts_1x1}, routes {routes_1x1}")
    want = {name: 0 for name in counts_1x1}
    want["flash_attention"] = SERVE_FLASH
    if not same:
        raise AssertionError("the sharded steps on 1 x 1 are not the unsharded steps bit for bit")
    if counts_1x1 != want or routes_1x1 != {"tensor_core": SERVE_FLASH, "cuda_core": 0}:
        raise AssertionError(f"1 x 1 launches {counts_1x1}, routes {routes_1x1}; want {want}, all tensor-core")
    del ref_logits, logits_1x1
    # (b) two ranks on the card over gloo
    queue = mp.get_context("spawn").SimpleQueue()
    t0 = time.perf_counter()
    mp.spawn(serve_rank, args=(free_port(), queue), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = sorted((queue.get() for _ in range(2)), key=lambda r: r["rank"])
    served = torch.from_numpy(ranks[0]["tokens"]).to(dev)
    with torch.no_grad():  # the reference teacher-forced on the run's tokens
        first, cache = spec.prefill(params, prompt)
        dc, rows = decode_cache(spec, cache, B, SERVE_MAX_LEN, device=dev), [first]
        del cache
        for i in range(FAMILY_NEW - 1):
            lg, dc = spec.decode_step(params, dc, served[:, i:i + 1], S + i)
            rows.append(lg)
    forced = torch.stack(rows, dim=1).float()
    del dc, rows, params
    gaps = forced.max(-1).values - forced.gather(-1, served.long()[..., None])[..., 0]
    worst = float(gaps.max())
    axes = dict(zip(("data", "model"), SERVE_MESH))
    dry = cache_bytes(spec, B, SERVE_MAX_LEN, axes)
    want_shape = (cfg.n_layers, B, SERVE_MAX_LEN // SERVE_MESH[1], cfg.n_kv_heads, cfg.resolved_head_dim)
    want_flash = f"{(B, S, cfg.n_heads // SERVE_MESH[1], cfg.resolved_head_dim)} / KV {cfg.n_kv_heads // SERVE_MESH[1]}"
    print(f"  (b) two ranks on {card}, gloo with CUDA tensors, mesh (data 1, model 2); {wall:.1f} s with the ranks' "
          f"start; tokens: {int((served != ref_tokens).sum())} of {served.numel()} differ from (a)'s; the largest gap "
          f"of a served token to the reference's max logit on its prefix {worst:.4f} (tol {NEAR_TIE}), "
          f"{int((gaps == 0).sum())}/{gaps.numel()} at the max")
    for r in ranks:
        gap = abs(r["grown"] - dry) / dry
        print(f"  rank {r['rank']}: cache {tuple(r['local_shape'])} (want {want_shape}), allocation "
              f"{r['grown'] / 1e6:.3f} MB against the dry run's {dry / 1e6:.3f} MB: gap {gap:.2e} (tol "
              f"{DRYRUN_MEM_RTOL}); prefill {r['prefill_ms']:.1f} ms, decode {r['decode_ms']:.2f} ms a step, "
              f"{B / r['decode_ms'] * 1e3:.1f} tok/s (gloo's host staging, not NVLink); flash {r['shapes']}; "
              f"peak {r['peak'] / 1e9:.2f} GB — on {card}")
        if gap > DRYRUN_MEM_RTOL or tuple(r["local_shape"]) != want_shape:
            raise AssertionError(f"rank {r['rank']}: the cache is not the dry run's under cache_pspec")
        if not np.array_equal(r["tokens"], ranks[0]["tokens"]):
            raise AssertionError("the two ranks returned different tokens")
        if r["shapes"] != {want_flash: SERVE_FLASH} or r["launches"]["flash_attention"] != SERVE_FLASH or \
                r["routes"] != {"tensor_core": SERVE_FLASH, "cuda_core": 0} or r["prefill_launches"] != r["launches"]:
            raise AssertionError(f"rank {r['rank']}: flash {r['launches']}, {r['routes']}, {r['shapes']}; want "
                                 f"{SERVE_FLASH} in the prefill, all tensor-core, at {want_flash}")
        if any(n for name, n in r["launches"].items() if name != "flash_attention"):
            raise AssertionError(f"rank {r['rank']}: the sharded steps launched other kernels: {r['launches']}")
    if worst > NEAR_TIE:
        raise AssertionError(f"a served token is {worst} below the reference's max logit")
    return counts_1x1, routes_1x1, ranks


def family_train_config(arch: str):
    """The config phase 11 trains: full width, FAMILY_TRAIN_LAYERS' depth."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg, layers = get_config(arch), FAMILY_TRAIN_LAYERS[arch]
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def family_train_batch(cfg, dev):
    """Phase 11's train batch: the config's train_4k microbatch rows of
    TRAIN_SEQ tokens from ``SyntheticLM`` and, for an encdec, TRAIN_SEQ // 4
    frames a row from the seed, bf16."""
    from repro_torch.data.pipeline import SyntheticLM

    rows = cfg.microbatch["train_4k"]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(cfg.vocab, TRAIN_SEQ, rows, seed=SEED)
             .batch_at(0).items()}
    if cfg.family == "encdec":
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        batch["frontend"] = torch.randn((rows, TRAIN_SEQ // 4, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    return batch


def host_train_state(spec, dev):
    """``make_train_state``'s state with a residual, drawn on the card from
    the seed (phase 11's (a) draws the same), moved to the host: placed on a
    mesh, the card then holds its shards alone."""
    from repro_torch.launch.steps import make_train_state

    state = make_train_state(spec, torch.Generator(device=dev).manual_seed(SEED), compress=True, device=dev)
    host = lambda leaves: {n: t.detach().cpu() for n, t in leaves.items()}  # noqa: E731
    out = {"params": host(state["params"]), "residual": host(state["residual"]),
           "opt": state["opt"]._replace(mu=host(state["opt"].mu), nu=host(state["opt"].nu),
                                        master=host(state["opt"].master))}
    del state
    torch.cuda.empty_cache()
    return out


def family_depth_allowed(arch: str, ref_bytes_per_param: int = 4) -> int:
    """The most layers the port's dry run lets two (1, 2) ranks and the
    unsharded step's bf16 params and mu (shared with them) hold on one card
    at train_4k (activations not counted): the depth a memory cut would
    take."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import DEVICE_BYTES, cell_bytes
    from repro_torch.models.api import ModelSpec

    full, axes = get_config(arch), dict(zip(("data", "model"), FAMILY_SPLIT_MESH))
    best = 0
    for n in range(1, full.n_layers + 1):
        cfg = dataclasses.replace(full, n_layers=n)
        need = 2 * cell_bytes(arch, "train_4k", axes, cfg=cfg)["total_bytes"] + \
            ref_bytes_per_param * ModelSpec(cfg).param_count()
        if need > DEVICE_BYTES:
            break
        best = n
    return best


def flash_recorder(shapes: dict):
    """A stand-in for ``dense.flash_attention`` that counts each call's
    shape in ``shapes``: (q's shape, the KV heads, the KV length)."""
    from repro_torch.models import dense

    inner = dense.flash_attention

    def recording(q, k, v, *, causal=True):
        key = (tuple(q.shape), k.shape[2], k.shape[1])  # q (B, S, heads, hd); the KV heads and length
        shapes[key] = shapes.get(key, 0) + 1
        return inner(q, k, v, causal=causal)

    return recording


def requested_bytes() -> int:
    """The bytes this process holds from the caching allocator as they were
    requested, before its rounding (a block under 1 MB past a request of
    over 1 MB is handed out whole, so ``memory_allocated`` can exceed a
    small tensor's bytes by up to 1 MB), once the blocks freed while gloo's
    copies were still using them are released (the allocator frees those
    when their streams finish)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def busy_share(prof, wall_ms: float):
    """(device busy ms of a profiled window, its idle share of ``wall_ms``):
    the union of this process's device ops (not gloo's annotations). The
    windows of the ranks trace the card alone: reading a host trace of a
    gloo-bound train step takes about a minute."""
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith("gloo:")]
    if not on_device:
        raise AssertionError("the profiler saw no device op")
    busy = union_ms(on_device)
    return busy, 1 - busy / wall_ms


def family_rank(rank: int, port: int, arch: str, ref, queue) -> None:
    """One rank of phase 11 (b) (a spawned process on device 0): ``arch``'s
    seed params placed on the (1, 2) mesh and served (a warm-up, then the
    run with the counts set to 0 before it; its last two decode steps under
    the profiler), then phase 11's train config's state placed on the mesh
    the split loss and gradients in fp32 from it, then one step (under the
    profiler). ``ref``: the unsharded step's step-0 mu, and the unsharded
    model's fp32 loss and gradients, on the card (CUDA IPC). Puts its
    numbers on ``queue``."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import OptimConfig, get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.launch.steps import (build_prefill_step, build_serve_step, build_train_step, compute_layout,
                                          decode_cache, shard_train_state)
    from repro_torch.models import dense, layers
    from repro_torch.models.api import ModelSpec

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=SPLIT_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cuda", FAMILY_SPLIT_MESH, mesh_dim_names=("data", "model"))
        out = {"rank": rank, "stages": {}}
        mark = time.perf_counter()

        def stage(name):  # this rank's seconds since the last stage
            nonlocal mark
            out["stages"][name] = time.perf_counter() - mark
            mark = time.perf_counter()

        # serving at full depth
        spec = ModelSpec(get_config(arch))
        whole = spec.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
        params = sharding.shard_params(spec, whole, mesh)
        del whole
        torch.cuda.empty_cache()
        prompt, frontend = family_inputs(spec.cfg, dev)
        B, S = prompt.shape
        prefill_step, serve_step = build_prefill_step(spec, mesh), build_serve_step(spec, mesh)
        short = 64  # warm-up on a short prompt: first calls, gloo's buffers
        tok, cache = prefill_step(params, prompt[:, :short], None if frontend is None else frontend[:, :short // 4])
        serve_step(params, decode_cache(spec, cache, B, SERVE_MAX_LEN, mesh=mesh), tok, short)
        del cache
        stage("params and warm-up")
        shapes = {}
        flash, dense.flash_attention = dense.flash_attention, flash_recorder(shapes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_launch_counts()
        t0 = time.perf_counter()
        tok, cache = prefill_step(params, prompt, frontend)
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["prefill_launches"] = dict(launch_counts())
        before = requested_bytes()
        dc = decode_cache(spec, cache, B, SERVE_MAX_LEN, mesh=mesh)
        out["cache_grown"] = requested_bytes() - before
        del cache
        toks = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(FAMILY_SPLIT_NEW - 3):
            tok, dc = serve_step(params, dc, tok, S + i)
            toks.append(tok)
        torch.cuda.synchronize()
        out["decode_ms"] = (time.perf_counter() - t0) / (FAMILY_SPLIT_NEW - 3) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(FAMILY_SPLIT_NEW - 3, FAMILY_SPLIT_NEW - 1):
                tok, dc = serve_step(params, dc, tok, S + i)
                toks.append(tok)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        out["decode_busy_ms"], out["decode_idle"] = busy_share(prof, wall)
        out["decode_busy_ms"] /= 2
        out.update(tokens=torch.cat(toks, dim=1).cpu().numpy(), serve_launches=dict(launch_counts()),
                   serve_routes=dict(route_counts()), serve_shapes=dict(shapes),
                   cache_shapes={k: tuple(sharding.local(v).shape) for k, v in dc.items()
                                 if isinstance(v, torch.Tensor)},
                   serve_peak=torch.cuda.max_memory_allocated())
        del params, dc
        torch.cuda.empty_cache()
        stage("serving")
        # one train step at phase 11's depth
        cfg = family_train_config(arch)
        tspec = ModelSpec(cfg)
        host = host_train_state(tspec, dev)
        before = requested_bytes()
        state = shard_train_state(tspec, host, mesh)
        out["state_grown"] = requested_bytes() - before
        del host
        stage("train state")
        optim = OptimConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=TRAIN_STEPS + 1)
        batch = family_train_batch(cfg, dev)
        sizes, coord = sharding.mesh_shape(mesh), sharding.mesh_coordinate(mesh)
        # the split in fp32 (the layout of the step, its params cast up) against the unsharded model's
        local32 = {n: sharding.local(p).detach().float().requires_grad_(True) for n, p in state["params"].items()}
        with layers.split_compute(compute_layout(tspec, mesh, state["params"])):
            grads32, loss32 = build_train_step(tspec, optim, FAMILY_TRAIN_ACCUM[arch]).grads_and_loss(local32, batch)
        del local32
        out["fp32_loss_gap"] = abs(float(loss32) - ref["loss32"]) / abs(ref["loss32"])
        out["fp32_gaps"] = {}
        for name, g in grads32.items():
            want = ref["grads32"][name]
            sl = sharding.shard_slices(want.shape, sharding.spec_of(state["params"][name]), sizes, coord)
            out["fp32_gaps"][name] = float((g - want[sl]).abs().max()) / max(float(want.abs().max()), 1e-30)
        del grads32
        torch.cuda.empty_cache()
        stage("fp32")
        step = build_train_step(tspec, optim, FAMILY_TRAIN_ACCUM[arch], mesh=mesh)
        shapes.clear()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            out["step_ms"] = (time.perf_counter() - t0) * 1e3
        out["step_busy_ms"], out["step_idle"] = busy_share(prof, out["step_ms"])
        out.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                   train_launches=dict(launch_counts()), train_routes=dict(route_counts()),
                   train_shapes=dict(shapes), train_peak=torch.cuda.max_memory_allocated())
        dense.flash_attention = flash
        out["mu_gaps"] = {}
        for name, p in state["params"].items():
            sl = sharding.shard_slices(ref["mu"][name].shape, sharding.spec_of(p), sizes, coord)
            mine, want = sharding.local(state["opt"].mu[name]), ref["mu"][name][sl].float()
            out["mu_gaps"][name] = float((mine - want).abs().max()) / max(float(ref["mu"][name].float().abs().max()),
                                                                        1e-30)
        stage("train step")
        queue.put(out)
    finally:
        dist.destroy_process_group()


def split_family(arch: str, card: str, near_tie: float):
    """Phase 11 for ``arch``: (a) the unsharded serving and train steps on
    the card; (c) 1 x 1 over a one-rank NCCL group, bit-equal to (a); (b)
    (1, 2) as two ranks on the card over gloo (``family_rank``). Returns
    ({path: (launch counts, routes)} of the four runs, (b)'s ranks)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.configs import OptimConfig, get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.launch.dryrun import cache_bytes, cell_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step, decode_cache, make_train_state, shard_train_state
    from repro_torch.models.api import ModelSpec
    from repro_torch.models.common import flat_leaves
    from repro_torch.optim.adamw import global_norm

    t_arch = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    spec = ModelSpec(cfg)
    params = spec.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompt, frontend = family_inputs(cfg, dev)
    B, S = prompt.shape
    tcfg, tspec = family_train_config(arch), ModelSpec(family_train_config(arch))
    accum, batch = FAMILY_TRAIN_ACCUM[arch], family_train_batch(family_train_config(arch), dev)
    rows = batch["tokens"].shape[0]
    allowed = family_depth_allowed(arch)
    print(f"  {arch}: serving {B} prompts of {S} tokens, {FAMILY_SPLIT_NEW} tokens each, cache max_len "
          f"{SERVE_MAX_LEN}{'' if frontend is None else f', frames {tuple(frontend.shape)}'}; training "
          f"{tspec.param_count() / 1e9:.3f} B params at {tcfg.n_layers} layers of {cfg.n_layers} (the dry run at "
          f"(1, 2) allows {allowed} on one card, activations not counted; cut to {tcfg.n_layers} for gloo's step "
          f"time), seq {TRAIN_SEQ}, {rows} rows in {accum} microbatches")
    optim = OptimConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=TRAIN_STEPS + 1)
    paths = {}
    flash_prefill = FAMILY_FLASH[arch]

    def check_launches(path, n):
        counts, routes = paths[path]
        if counts != {**{k: 0 for k in counts}, "flash_attention": n} or routes != {"tensor_core": n, "cuda_core": 0}:
            raise AssertionError(f"{path}: launches {counts}, routes {routes}; want {n} flash, all tensor-core")

    # (a) the unsharded serving steps; (c) the same over a one-rank NCCL group, bit for bit
    ref_tokens, ref_logits, ref_prefill, ref_decode = serve_run(spec, params, prompt, None, frontend, FAMILY_SPLIT_NEW)
    print(f"  (a) unsharded serving: prefill {ref_prefill:.1f} ms, decode {ref_decode:.2f} ms a step, "
          f"{B / ref_decode * 1e3:.1f} tok/s — on {card}")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_host_mesh("cuda")
        sharded = sharding.shard_params(spec, params, mesh)
        del params  # drawn again for (b)'s reference
        reset_launch_counts()
        tokens_1x1, logits_1x1, _, _ = serve_run(spec, sharded, prompt, mesh, frontend, FAMILY_SPLIT_NEW)
        paths[f"serve split 1x1 {arch}"] = (launch_counts(), route_counts())
        del sharded
        serve_same = torch.equal(tokens_1x1, ref_tokens) and len(logits_1x1) == len(ref_logits) and \
            all(torch.equal(a, b) for a, b in zip(logits_1x1, ref_logits))
        del ref_logits, logits_1x1
        torch.cuda.empty_cache()
        # (a) the unsharded train step 0
        state = make_train_state(tspec, torch.Generator(device=dev).manual_seed(SEED), compress=True, device=dev)
        params32 = {n: p.detach().float() for n, p in state["params"].items()}
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = build_train_step(tspec, optim, accum)(state, batch)
        torch.cuda.synchronize()
        ref_step_ms = (time.perf_counter() - t0) * 1e3
        ref_flash = launch_counts()["flash_attention"]
        ref_m = {k: float(v) for k, v in m.items()}
        ref_params = {n: p.detach().clone() for n, p in state["params"].items()}
        ref = {"mu": {n: t.to(torch.bfloat16) for n, t in state["opt"].mu.items()}}
        print(f"  (a) unsharded train step 0: loss {ref_m['loss']:.6f} grad_norm {ref_m['grad_norm']:.6f}; "
              f"{ref_step_ms:.1f} ms, {rows * TRAIN_SEQ / ref_step_ms * 1e3:.0f} tokens/s; flash {ref_flash}; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB — on {card}")
        del state, m
        torch.cuda.empty_cache()
        # the unsharded model in fp32 on the same batch: the split's fp32 reference, and the bf16 step's own
        # noise (its loss, grad norm and mu against those the fp32 gradient gives)
        leaves32 = {n: t.requires_grad_(True) for n, t in params32.items()}
        grads32, loss32 = build_train_step(tspec, optim, accum).grads_and_loss(leaves32, batch)
        del leaves32, params32
        torch.cuda.empty_cache()
        # (c) the train step on 1 x 1, the state drawn as (a)'s
        host = host_train_state(tspec, dev)
        sharded = shard_train_state(tspec, host, mesh)
        del host
        reset_launch_counts()
        sharded, m = build_train_step(tspec, optim, accum, mesh=mesh)(sharded, batch)
        paths[f"train split 1x1 {arch}"] = (launch_counts(), route_counts())
        train_same = {k: float(v) for k, v in m.items()} == ref_m and \
            all(torch.equal(sharding.local(p), ref_params[n]) for n, p in sharded["params"].items())
        del sharded, m, ref_params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    gnorm32 = float(global_norm(grads32))
    scale32 = min(1.0, optim.grad_clip / (gnorm32 + 1e-9))
    noise = {"loss": abs(ref_m["loss"] - float(loss32)) / ref_m["loss"],
             "grad_norm": abs(ref_m["grad_norm"] - gnorm32) / ref_m["grad_norm"]}
    noise_mu = {n: float((ref["mu"][n].float() - (1 - optim.b1) * scale32 * g).abs().max())
                / max(float(ref["mu"][n].float().abs().max()), 1e-30) for n, g in grads32.items()}
    ref.update(grads32=grads32, loss32=float(loss32))
    sums = {n for n, leaf in flat_leaves(tspec.schema()) if sum(a != "layers" for a in leaf.axes) <= 1}
    mu_tols = {n: max(SPLIT_MU_TOL_SUMS if n in sums else SPLIT_MU_TOL, 2 * noise_mu[n]) for n in noise_mu}
    loss_tol, gnorm_tol = max(SPLIT_LOSS_RTOL, 2 * noise["loss"]), max(SPLIT_GNORM_RTOL, 2 * noise["grad_norm"])
    noisiest = sorted(noise_mu, key=lambda n: -noise_mu[n])[:3]
    print(f"  (a) the same step in fp32: loss {float(loss32):.6f} grad_norm {gnorm32:.6f}; the bf16 step's own "
          f"distance from it: loss {noise['loss']:.3g}, grad norm {noise['grad_norm']:.3g}, mu (of its max) "
          + ", ".join(f"{n} {noise_mu[n]:.3g}" for n in noisiest))
    print(f"  (c) 1 x 1 over NCCL: serving tokens and every step's logits bit-equal to (a): {serve_same}; train "
          f"step 0's metrics and every updated param bit-equal to (a): {train_same}; launches "
          + ", ".join(f"{p}: {c['flash_attention']} flash, {r}" for p, (c, r) in paths.items()))
    if not (serve_same and train_same):
        raise AssertionError(f"{arch}: the split steps on 1 x 1 are not the unsharded steps bit for bit")
    check_launches(f"serve split 1x1 {arch}", flash_prefill)
    check_launches(f"train split 1x1 {arch}", ref_flash)
    # (b) two ranks on the card over gloo
    queue = mp.get_context("spawn").SimpleQueue()
    t0 = time.perf_counter()
    mp.spawn(family_rank, args=(free_port(), arch, ref, queue), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = sorted((queue.get() for _ in range(2)), key=lambda r: r["rank"])
    del ref, grads32
    torch.cuda.ipc_collect()  # the blocks the ranks held through CUDA IPC
    torch.cuda.empty_cache()
    params = spec.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)  # drawn again, as (a)'s
    served = torch.from_numpy(ranks[0]["tokens"]).to(dev)
    with torch.no_grad():  # the unsharded steps teacher-forced on the run's tokens
        first, cache = spec.prefill(params, prompt, frontend)
        dc, steps_ = decode_cache(spec, cache, B, SERVE_MAX_LEN, device=dev), [first]
        del cache
        for i in range(FAMILY_SPLIT_NEW - 1):
            lg, dc = spec.decode_step(params, dc, served[:, i:i + 1], S + i)
            steps_.append(lg)
    forced = torch.stack(steps_, dim=1).float()
    del dc, steps_, params
    torch.cuda.empty_cache()
    gaps = forced.max(-1).values - forced.gather(-1, served.long()[..., None])[..., 0]
    worst = float(gaps.max())
    axes = dict(zip(("data", "model"), FAMILY_SPLIT_MESH))
    dry_cache = cache_bytes(spec, B, SERVE_MAX_LEN, axes)
    dry_train = cell_bytes(arch, "train_4k", axes, cfg=tcfg)
    want_state = dry_train["bytes"]["state"] + dry_train["bytes"]["residual"]
    pspec = spec.cache_pspec()
    want_shapes = {k: sharding.local_shape(t.shape, sharding.filter_spec_for_mesh(pspec[k], axes, t.shape), axes)
                   for k, t in spec.cache_specs(B, SERVE_MAX_LEN).items() if t.dim()}
    hd = cfg.resolved_head_dim
    print(f"  (b) two ranks on {card}, gloo with CUDA tensors, mesh (data 1, model 2); {wall:.1f} s with the ranks' "
          f"start; tokens: {int((served != ref_tokens).sum())} of {served.numel()} differ from (a)'s; the largest gap "
          f"of a served token to (a)'s teacher-forced max logit on its prefix {worst:.4f} (tol phase 6's "
          f"max({NEAR_TIE}, 2 x bf16 noise) = {near_tie:.4f}), {int((gaps == 0).sum())}/{gaps.numel()} at the max; "
          "rank 0's seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["stages"].items()))
    for r in ranks:
        gap = abs(r["cache_grown"] - dry_cache) / dry_cache
        state_gap = abs(r["state_grown"] - want_state) / want_state
        dl = abs(r["loss"] - ref_m["loss"]) / ref_m["loss"]
        dg = abs(r["grad_norm"] - ref_m["grad_norm"]) / ref_m["grad_norm"]
        worst_mu = sorted(r["mu_gaps"], key=lambda n: -r["mu_gaps"][n] / mu_tols[n])[:3]
        worst32 = max(r["fp32_gaps"], key=lambda n: r["fp32_gaps"][n])
        tol32 = FAMILY_FP32_TOL.get(arch, FAMILY_FP32_TOL_DEFAULT)
        print(f"  rank {r['rank']} serving: cache {r['cache_shapes']}, requested {r['cache_grown'] / 1e6:.3f} MB "
              f"against the dry run's {dry_cache / 1e6:.3f} MB: gap {gap:.2e} (tol {FAMILY_CACHE_RTOL}); prefill "
              f"{r['prefill_ms']:.1f} ms, decode {r['decode_ms']:.2f} ms a step, {B / r['decode_ms'] * 1e3:.1f} tok/s "
              f"(gloo's host staging, not NVLink); profiled decode: busy {r['decode_busy_ms']:.2f} ms a step, idle "
              f"share {r['decode_idle']:.3f}; flash {r['serve_shapes']}; peak {r['serve_peak'] / 1e9:.2f} GB")
        print(f"  rank {r['rank']} training: state + residual {r['state_grown'] / 1e9:.3f} GB against the dry run's "
              f"{want_state / 1e9:.3f} GB: gap {state_gap:.2e} (tol {DRYRUN_MEM_RTOL}); step 0 loss {r['loss']:.6f} "
              f"grad_norm {r['grad_norm']:.6f}: gaps to (a) {dl:.3g} (tol {loss_tol:.3g}), {dg:.3g} (tol "
              f"{gnorm_tol:.3g}); mu, the largest of their tolerance: "
              + ", ".join(f"{n} {r['mu_gaps'][n]:.3g} (tol {mu_tols[n]:.3g})" for n in worst_mu)
              + f"; in fp32 against the unsharded model: loss {r['fp32_loss_gap']:.3g} (tol {SPLIT_LOSS_RTOL}), "
              f"gradients {r['fp32_gaps'][worst32]:.3g} of the leaf's max at most ({worst32}; tol {tol32})"
              + f"; step {r['step_ms']:.1f} ms (profiled), {rows * TRAIN_SEQ / r['step_ms'] * 1e3:.0f} tokens/s, "
              f"busy {r['step_busy_ms']:.1f} ms, idle share {r['step_idle']:.3f}; flash {r['train_shapes']}; peak "
              f"{r['train_peak'] / 1e9:.2f} GB against the dry run's {dry_train['total_bytes'] / 1e9:.3f} GB a device "
              f"(activations not counted) — on {card}")
        if r["cache_shapes"] != want_shapes:
            raise AssertionError(f"rank {r['rank']}: the cache's local shapes {r['cache_shapes']} are not "
                                 f"cache_pspec's {want_shapes}")
        if gap > FAMILY_CACHE_RTOL:
            raise AssertionError(f"rank {r['rank']}: the cache's allocation is not the dry run's cache_bytes")
        if state_gap > DRYRUN_MEM_RTOL:
            raise AssertionError(f"rank {r['rank']}: the dry run's state bytes are not the card's allocation")
        if not np.array_equal(r["tokens"], ranks[0]["tokens"]):
            raise AssertionError("the two ranks returned different tokens")
        if r["serve_launches"] != {**{k: 0 for k in r["serve_launches"]}, "flash_attention": flash_prefill} or \
                r["prefill_launches"] != r["serve_launches"] or \
                r["serve_routes"] != {"tensor_core": flash_prefill, "cuda_core": 0}:
            raise AssertionError(f"rank {r['rank']}: serving launches {r['serve_launches']} (prefill "
                                 f"{r['prefill_launches']}), {r['serve_routes']}; want {flash_prefill} flash in the "
                                 "prefill, none in decode, all tensor-core")
        if r["train_launches"] != {**{k: 0 for k in r["train_launches"]}, "flash_attention": ref_flash} or \
                r["train_routes"] != {"tensor_core": ref_flash, "cuda_core": 0}:
            raise AssertionError(f"rank {r['rank']}: train launches {r['train_launches']}, {r['train_routes']}; "
                                 f"want the unsharded step's {ref_flash} flash, all tensor-core")
        heads = {(q[2], q[3], kv) for q, kv, _ in list(r["serve_shapes"]) + list(r["train_shapes"])}
        local = cfg.n_heads // FAMILY_SPLIT_MESH[1]
        if heads - {(local, hd, cfg.n_kv_heads // FAMILY_SPLIT_MESH[1])}:
            raise AssertionError(f"rank {r['rank']}: flash ran at (heads, hd, KV heads) {heads}, not a rank's "
                                 f"{local} heads")
        if r["fp32_loss_gap"] > SPLIT_LOSS_RTOL or r["fp32_gaps"][worst32] > tol32:
            raise AssertionError(f"rank {r['rank']}: in fp32 the split loss or gradients are not the unsharded "
                                 f"model's ({r['fp32_loss_gap']:.3g}, {worst32} {r['fp32_gaps'][worst32]:.3g})")
        if dl > loss_tol or dg > gnorm_tol:
            raise AssertionError(f"rank {r['rank']}: the split step 0's loss or grad norm is not (a)'s")
        off = {n: g for n, g in r["mu_gaps"].items() if not g <= mu_tols[n]}
        if off:
            raise AssertionError(f"rank {r['rank']}: the split step 0's mu is not (a)'s in {off}")
    if worst > near_tie:
        raise AssertionError(f"a served token is {worst} below the unsharded steps' max logit")
    for part in ("serve", "train"):
        counts = {k: sum(r[f"{part}_launches"][k] for r in ranks) for k in ranks[0][f"{part}_launches"]}
        routes = {k: sum(r[f"{part}_routes"][k] for r in ranks) for k in ranks[0][f"{part}_routes"]}
        paths[f"{part} split 1x2 {arch}"] = (counts, routes)
    print(f"  {arch}: {time.perf_counter() - t_arch:.1f} s")
    return paths, ranks


def split_families(card, bounds):
    """Phase 11: ``split_family`` of each of FAMILY_ARCHS. Returns {path:
    (launch counts, routes)} and each arch's ranks."""
    paths, ranks = {}, {}
    for arch in FAMILY_ARCHS:
        got, ranks[arch] = split_family(arch, card, bounds[arch])
        paths.update(got)
        torch.cuda.empty_cache()
    return paths, ranks


def layout_state(spec, dev, host: bool):
    """``make_train_state``'s state (no residual) drawn on the card from the
    seed, as (a) trains it; with ``host`` moved to the host, so that placed
    on a mesh the card holds what ``shard_train_state`` puts there alone."""
    from repro_torch.launch.steps import make_train_state

    state = make_train_state(spec, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    if not host:
        return state
    moved = lambda leaves: {n: t.detach().cpu() for n, t in leaves.items()}  # noqa: E731
    out = {"params": moved(state["params"]),
           "opt": state["opt"]._replace(mu=moved(state["opt"].mu), nu=moved(state["opt"].nu),
                                        master=moved(state["opt"].master))}
    del state
    torch.cuda.empty_cache()
    return out


def layout_batch(cfg, dev):
    """Phase 12's train batch: LAYOUT_ROWS rows of TRAIN_SEQ tokens from
    ``SyntheticLM``."""
    from repro_torch.data.pipeline import SyntheticLM

    return {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(cfg.vocab, TRAIN_SEQ, LAYOUT_ROWS, seed=SEED)
            .batch_at(0).items()}


def param_digest(params) -> str:
    """A SHA-256 of the bf16 bit patterns of each rank's params' shards."""
    import hashlib

    from repro_torch.distributed import sharding

    h = hashlib.sha256()
    for name in sorted(params):
        h.update(sharding.local(params[name]).detach().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def recorded_leaf_norms(into: dict):
    """Within the block, the norm of each gradient leaf the train step hands
    to its clip (this rank's shard) is put in ``into`` by name."""
    from repro_torch.launch import steps

    inner = steps.leaf_square_sums

    def recording(grads):
        into.update({n: float(g.double().pow(2).sum()) ** 0.5 for n, g in grads.items()})
        return inner(grads)

    steps.leaf_square_sums = recording
    try:
        yield
    finally:
        steps.leaf_square_sums = inner


@contextlib.contextmanager
def recorded_collectives(into: list):
    """Within the block, every ``torch.distributed`` all-reduce and
    all-gather this process issues is appended to ``into`` as (op, dtype,
    elements)."""
    import torch.distributed as dist

    reduce, gather, gather_into = dist.all_reduce, dist.all_gather, dist.all_gather_into_tensor

    def all_reduce(t, op=dist.ReduceOp.SUM, *args, **kwargs):
        into.append(("all_reduce " + str(op).split(".")[-1], str(t.dtype), t.numel()))
        return reduce(t, op, *args, **kwargs)

    def all_gather(parts, t, *args, **kwargs):
        into.append(("all_gather", str(t.dtype), t.numel()))
        return gather(parts, t, *args, **kwargs)

    def all_gather_into_tensor(out, t, *args, **kwargs):
        into.append(("all_gather", str(t.dtype), t.numel()))
        return gather_into(out, t, *args, **kwargs)

    dist.all_reduce, dist.all_gather, dist.all_gather_into_tensor = all_reduce, all_gather, all_gather_into_tensor
    try:
        yield
    finally:
        dist.all_reduce, dist.all_gather, dist.all_gather_into_tensor = reduce, gather, gather_into


def layout_rank(rank: int, port: int, queue) -> None:
    """One rank of phase 12 (b) and (d) (a spawned process on device 0): the
    "dp" train step of smollm-135m on (1, 2), then whisper-base served
    under "dp" on (1, 2) and qwen3-1.7b under "tp_only" on (2, 1) (a warm-up
    on a short prompt, then the run with the counts set to 0 before it).
    Puts its numbers on ``queue``."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import OptimConfig, get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import CountingWeights
    from repro_torch.models import dense, encdec
    from repro_torch.models.api import ModelSpec

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=SPLIT_TIMEOUT_S))
    try:
        out = {"rank": rank, "stages": {}, "serve": {}}
        mark = time.perf_counter()

        def stage(name):  # this rank's seconds since the last stage
            nonlocal mark
            out["stages"][name] = time.perf_counter() - mark
            mark = time.perf_counter()

        # (b) the "dp" train step
        mesh = init_device_mesh("cuda", LAYOUT_MESH, mesh_dim_names=("data", "model"))
        spec = ModelSpec(get_config(LAYOUT_ARCH))
        host = layout_state(spec, dev, host=True)
        before = requested_bytes()
        state = steps.shard_train_state(spec, host, mesh, sharding.layout_rules("dp"))
        out["state_grown"] = requested_bytes() - before
        del host
        batch = layout_batch(spec.cfg, dev)
        optim = OptimConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=TRAIN_STEPS + 1)
        step = steps.build_train_step(spec, optim, LAYOUT_ACCUM, mesh=mesh, layout="dp")
        stage("train state")
        shapes, calls = {}, []
        flash = dense.flash_attention  # recorded where the unsplit encdec calls it too
        dense.flash_attention = encdec.flash_attention = flash_recorder(shapes)
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_launch_counts()
        out["leaf_norms"] = {}
        with recorded_collectives(calls), recorded_leaf_norms(out["leaf_norms"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            out["step_ms"] = (time.perf_counter() - t0) * 1e3
        out.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                   train_launches=dict(launch_counts()), train_routes=dict(route_counts()), train_shapes=dict(shapes),
                   train_peak=torch.cuda.max_memory_allocated(), digest=param_digest(state["params"]),
                   collectives=calls)
        del state
        torch.cuda.empty_cache()
        stage("train step")
        # (d) serving in the layouts
        for arch, layout, shape in LAYOUT_SERVE:
            smesh = mesh if shape == LAYOUT_MESH else init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
            sspec = ModelSpec(get_config(arch))
            whole = sspec.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
            params = sharding.shard_params(sspec, whole, smesh, sharding.layout_rules(layout))
            del whole
            torch.cuda.empty_cache()
            prompt, frontend = family_inputs(sspec.cfg, dev)
            B, S = prompt.shape
            counted = []

            def counting_weights(*args):
                counted.append(CountingWeights(*args))
                return counted[-1]

            inner_weights, steps.DataParallelWeights = steps.DataParallelWeights, counting_weights
            prefill_step, serve_step = steps.build_prefill_step(sspec, smesh, layout), \
                steps.build_serve_step(sspec, smesh, layout)
            short = 64  # warm-up on a short prompt: first calls, gloo's buffers
            tok, cache = prefill_step(params, prompt[:, :short], None if frontend is None else frontend[:, :short // 4])
            serve_step(params, steps.decode_cache(sspec, cache, B, SERVE_MAX_LEN, mesh=smesh, layout=layout), tok, short)
            del cache
            shapes.clear()
            torch.cuda.synchronize()
            dist.barrier()
            reset_launch_counts()
            t0 = time.perf_counter()
            tok, cache = prefill_step(params, prompt, frontend)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            prefill_launches = dict(launch_counts())
            dc = steps.decode_cache(sspec, cache, B, SERVE_MAX_LEN, mesh=smesh, layout=layout)
            del cache
            toks = [tok]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(FAMILY_NEW - 1):
                tok, dc = serve_step(params, dc, tok, S + i)
                toks.append(tok)
            torch.cuda.synchronize()
            steps.DataParallelWeights = inner_weights
            out["serve"][arch] = {
                "tokens": torch.cat(toks, dim=1).cpu().numpy(), "prefill_ms": prefill_ms,
                "decode_ms": (time.perf_counter() - t0) / (FAMILY_NEW - 1) * 1e3, "prefill_launches": prefill_launches,
                "launches": dict(launch_counts()), "routes": dict(route_counts()), "shapes": dict(shapes),
                "gathered_peak": max((w.peak for w in counted), default=0),
                "cache_shapes": {k: tuple(sharding.local(v).shape) for k, v in dc.items() if isinstance(v, torch.Tensor)}}
            del params, dc
            torch.cuda.empty_cache()
            stage(f"serve {arch}")
        dense.flash_attention = encdec.flash_attention = flash
        queue.put(out)
    finally:
        dist.destroy_process_group()


def layout_flash_rank(rank: int, queue) -> None:
    """Phase 12's flash attention rows (forward and backward at
    FLASH_LAYOUT_SHAPES) in a spawned process on device 0: after phases
    8–11 the main process's profiler windows record no device op (chip run
    3 of PR 21), where a fresh process's do, as phase 11's ranks show."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    queue.put((check_flash_family_shapes(FLASH_LAYOUT_SHAPES), check_flash_backward(FLASH_LAYOUT_SHAPES)))


def layout_profiles(card):
    """Phase 12: flash attention at smollm-135m's train shapes, then (a) its
    unsharded train step, (c) "dp" on 1 x 1 over NCCL, (b) "dp" on (1, 2)
    and (d) "dp" and "tp_only" serving as two ranks on the card
    (``layout_rank``). Returns (the flash forward rows, the backward rows,
    {path: (launch counts, routes)}, the ranks)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.configs import OptimConfig, get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import cell_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import ModelSpec
    from repro_torch.models.common import flat_leaves
    from repro_torch.optim.adamw import global_norm

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    queue = mp.get_context("spawn").SimpleQueue()
    mp.spawn(layout_flash_rank, args=(queue,), nprocs=1, join=True)
    flash_rows, bwd_rows = queue.get()
    cfg = get_config(LAYOUT_ARCH)
    spec = ModelSpec(cfg)
    optim = OptimConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=TRAIN_STEPS + 1)
    batch = layout_batch(cfg, dev)
    paths = {}

    def check_launches(path, n):
        counts, routes = paths[path]
        if counts != {**{k: 0 for k in counts}, "flash_attention": n} or routes != {"tensor_core": n, "cuda_core": 0}:
            raise AssertionError(f"{path}: launches {counts}, routes {routes}; want {n} flash, all tensor-core")

    # (a) the unsharded step
    state = layout_state(spec, dev, host=False)
    params32 = {n: p.detach().float() for n, p in state["params"].items()}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ref_norms = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_leaf_norms(ref_norms):
        state, m = steps.build_train_step(spec, optim, LAYOUT_ACCUM)(state, batch)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    paths[f"train {LAYOUT_ARCH}"] = (launch_counts(), route_counts())
    ref_m = {k: float(v) for k, v in m.items()}
    ref_params = {n: p.detach().clone() for n, p in state["params"].items()}
    print(f"  {LAYOUT_ARCH}: {spec.param_count() / 1e6:.1f} M params, {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV; seq {TRAIN_SEQ}, {LAYOUT_ROWS} rows in {LAYOUT_ACCUM} "
          f"microbatches")
    print(f"  (a) unsharded train step 0: loss {ref_m['loss']:.6f} grad_norm {ref_m['grad_norm']:.6f}; {ref_ms:.1f} ms "
          f"(the first step), {LAYOUT_ROWS * TRAIN_SEQ / ref_ms * 1e3:.0f} tokens/s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB — on {card}")
    del state, m
    torch.cuda.empty_cache()
    check_launches(f"train {LAYOUT_ARCH}", LAYOUT_FLASH_PER_STEP)
    # the same gradient in fp32 (the params cast up): how far (a)'s bf16 loss and grad norm lie from it sets
    # (b)'s limits where that is above phase 9's, as phase 11 sets them
    leaves32 = {n: t.requires_grad_(True) for n, t in params32.items()}
    grads32, loss32 = steps.build_train_step(spec, optim, LAYOUT_ACCUM).grads_and_loss(leaves32, batch)
    gnorm32 = float(global_norm(grads32))
    norms32 = {n: float(g.double().pow(2).sum()) ** 0.5 for n, g in grads32.items()}
    del leaves32, params32, grads32
    torch.cuda.empty_cache()
    noise = {"loss": abs(ref_m["loss"] - float(loss32)) / ref_m["loss"],
             "grad_norm": abs(ref_m["grad_norm"] - gnorm32) / ref_m["grad_norm"]}
    loss_tol, gnorm_tol = max(SPLIT_LOSS_RTOL, 2 * noise["loss"]), max(SPLIT_GNORM_RTOL, 2 * noise["grad_norm"])
    print(f"  (a) the same gradient in fp32: loss {float(loss32):.6f} grad_norm {gnorm32:.6f}; the bf16 step's own "
          f"distance from it: loss {noise['loss']:.3g}, grad norm {noise['grad_norm']:.3g}")
    # (c) "dp" on 1 x 1 over a one-rank NCCL group: bit for bit
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_host_mesh("cuda")
        sharded = steps.shard_train_state(spec, layout_state(spec, dev, host=True), mesh, sharding.layout_rules("dp"))
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded, m = steps.build_train_step(spec, optim, LAYOUT_ACCUM, mesh=mesh, layout="dp")(sharded, batch)
        torch.cuda.synchronize()
        ms_1x1 = (time.perf_counter() - t0) * 1e3
        paths[f"train dp 1x1 {LAYOUT_ARCH}"] = (launch_counts(), route_counts())
        same = {k: float(v) for k, v in m.items()} == ref_m and \
            all(torch.equal(sharding.local(p), ref_params[n]) for n, p in sharded["params"].items())
        del sharded, m
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"  (c) \"dp\" on 1 x 1 over NCCL: step 0's metrics and every updated param bit-equal to (a): {same}; "
          f"{ms_1x1:.1f} ms")
    if not same:
        raise AssertionError("the \"dp\" step on 1 x 1 is not the unsharded step bit for bit")
    check_launches(f"train dp 1x1 {LAYOUT_ARCH}", LAYOUT_FLASH_PER_STEP)
    del ref_params
    torch.cuda.empty_cache()
    # (b) and (d): two ranks on the card over gloo
    t0 = time.perf_counter()
    mp.spawn(layout_rank, args=(free_port(), queue), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = sorted((queue.get() for _ in range(2)), key=lambda r: r["rank"])
    torch.cuda.empty_cache()
    want_state = cell_bytes(LAYOUT_ARCH, "train_4k", dict(zip(("data", "model"), LAYOUT_MESH)), cfg=cfg,
                            layout="dp")["bytes"]
    leaves = {n: leaf for n, leaf in flat_leaves(spec.schema())}
    grad_sizes = {math.prod(leaf.shape[1:] if leaf.axes[0] == "layers" else leaf.shape) for leaf in leaves.values()}
    want_flash = ((LAYOUT_ROWS // LAYOUT_ACCUM // LAYOUT_MESH[1], TRAIN_SEQ, cfg.n_heads, cfg.resolved_head_dim),
                  cfg.n_kv_heads, TRAIN_SEQ)
    print(f"  (b) \"dp\" on (data 1, model 2): two ranks on {card}, gloo with CUDA tensors; {wall:.1f} s with the "
          "ranks' start; rank 0's seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["stages"].items()))
    for r in ranks:
        dl = abs(r["loss"] - ref_m["loss"]) / ref_m["loss"]
        dg = abs(r["grad_norm"] - ref_m["grad_norm"]) / ref_m["grad_norm"]
        gap = abs(r["state_grown"] - want_state["state"]) / want_state["state"]
        kinds = {}
        for op, dtype, n in r["collectives"]:
            kinds[op, dtype] = kinds.get((op, dtype), 0) + n
        tp = [c for c in r["collectives"] if not (c[0] == "all_reduce SUM" and (
            (c[1] == "torch.bfloat16" and c[2] in grad_sizes) or (c[1] == "torch.float32" and c[2] <= len(leaves))))]
        print(f"  rank {r['rank']}: step 0 loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f}: gaps to (a) {dl:.3g} "
              f"(tol {loss_tol:.3g}), {dg:.3g} (tol {gnorm_tol:.3g}); {r['step_ms']:.1f} ms (the first step; "
              f"gloo's host staging), {LAYOUT_ROWS * TRAIN_SEQ / r['step_ms'] * 1e3:.0f} tokens/s; state "
              f"{r['state_grown'] / 1e9:.4f} GB against the \"dp\" dry run's {want_state['state'] / 1e9:.4f} GB: gap "
              f"{gap:.2e} (tol {DRYRUN_MEM_RTOL}); collectives: "
              + ", ".join(f"{op} {dtype[6:]} x{sum(1 for c in r['collectives'] if c[:2] == (op, dtype))} "
                          f"({n * (2 if 'bfloat16' in dtype else 4) / 1e6:.1f} MB)" for (op, dtype), n in kinds.items())
              + f"; flash {r['train_shapes']}; peak {r['train_peak'] / 1e9:.2f} GB")
        top = sorted(norms32, key=lambda n: -norms32[n])[:4]
        print(f"    rank {r['rank']}: the largest leaves' gradient norms, (b) / (a) / fp32: "
              + ", ".join(f"{n} {r['leaf_norms'][n]:.5f} / {ref_norms[n]:.5f} / {norms32[n]:.5f}" for n in top))
        if dl > loss_tol or dg > gnorm_tol:
            raise AssertionError(f"rank {r['rank']}: the \"dp\" step 0's loss or grad norm is not (a)'s")
        if gap > DRYRUN_MEM_RTOL:
            raise AssertionError(f"rank {r['rank']}: the \"dp\" dry run's state bytes are not the card's allocation")
        if tp or not kinds:
            raise AssertionError(f"rank {r['rank']}: collectives beyond the gradient's, the loss's and the norm's: "
                                 f"{tp[:5]}")
        if r["train_launches"] != {**{k: 0 for k in r["train_launches"]}, "flash_attention": LAYOUT_FLASH_PER_STEP} or \
                r["train_routes"] != {"tensor_core": LAYOUT_FLASH_PER_STEP, "cuda_core": 0} or \
                r["train_shapes"] != {want_flash: LAYOUT_FLASH_PER_STEP}:
            raise AssertionError(f"rank {r['rank']}: train launches {r['train_launches']}, {r['train_routes']}, "
                                 f"{r['train_shapes']}; want {LAYOUT_FLASH_PER_STEP} flash at {want_flash}, all "
                                 "tensor-core")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("the \"dp\" ranks' updated params differ")
    print(f"  (b) both ranks' updated params bit-equal: sha256 {ranks[0]['digest'][:16]}")
    paths[f"train dp 1x2 {LAYOUT_ARCH}"] = ({k: sum(r["train_launches"][k] for r in ranks) for k in ranks[0]["train_launches"]},
                                           {k: sum(r["train_routes"][k] for r in ranks) for k in ranks[0]["train_routes"]})
    # (d) each served token against the unsharded steps, teacher-forced on the run's tokens
    for arch, layout, shape in LAYOUT_SERVE:
        sspec = ModelSpec(get_config(arch))
        params = sspec.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
        prompt, frontend = family_inputs(sspec.cfg, dev)
        B, S = prompt.shape
        ref_tokens, _, ref_prefill, ref_decode = serve_run(sspec, params, prompt, None, frontend, FAMILY_NEW)
        served = torch.from_numpy(ranks[0]["serve"][arch]["tokens"]).to(dev)
        with torch.no_grad():
            first, cache = sspec.prefill(params, prompt, frontend)
            dc, logits = steps.decode_cache(sspec, cache, B, SERVE_MAX_LEN, device=dev), [first]
            del cache
            for i in range(FAMILY_NEW - 1):
                lg, dc = sspec.decode_step(params, dc, served[:, i:i + 1], S + i)
                logits.append(lg)
        forced = torch.stack(logits, dim=1).float()
        del dc, logits, params
        torch.cuda.empty_cache()
        gaps = forced.max(-1).values - forced.gather(-1, served.long()[..., None])[..., 0]
        worst = float(gaps.max())
        path = f"serve {layout} {shape[0]}x{shape[1]} {arch}"
        n_flash = LAYOUT_SERVE_FLASH[arch]
        print(f"  (d) {arch} under \"{layout}\" on (data {shape[0]}, model {shape[1]}), {B} prompts of {S} tokens"
              f"{'' if frontend is None else f' (frames {tuple(frontend.shape)})'}, {FAMILY_NEW} tokens each: "
              f"{int((served == ref_tokens).sum())} of {served.numel()} tokens equal to the unsharded steps' (prefill "
              f"{ref_prefill:.1f} ms, decode {ref_decode:.2f} ms a step); the largest gap of a served token to their "
              f"teacher-forced max logit {worst:.4f} (tol {NEAR_TIE}), {int((gaps == 0).sum())}/{gaps.numel()} at the max")
        for r in ranks:
            x = r["serve"][arch]
            print(f"    rank {r['rank']}: prefill {x['prefill_ms']:.1f} ms, decode {x['decode_ms']:.2f} ms a step, "
                  f"{B / x['decode_ms'] * 1e3:.1f} tok/s; cache {x['cache_shapes']}; flash {x['shapes']}; weight "
                  f"bytes gathered over \"data\" at once {x['gathered_peak']}")
            if not np.array_equal(x["tokens"], ranks[0]["serve"][arch]["tokens"]):
                raise AssertionError(f"{path}: the two ranks returned different tokens")
            if x["launches"] != {**{k: 0 for k in x["launches"]}, "flash_attention": n_flash} or \
                    x["prefill_launches"] != x["launches"] or x["routes"] != {"tensor_core": n_flash, "cuda_core": 0}:
                raise AssertionError(f"{path} rank {r['rank']}: launches {x['launches']} (prefill "
                                     f"{x['prefill_launches']}), {x['routes']}; want {n_flash} flash in the prefill, "
                                     "none in decode, all tensor-core")
            rows = {q[0] for q, _, _ in x["shapes"]}
            if rows != {B // 2}:
                raise AssertionError(f"{path} rank {r['rank']}: flash ran on {rows} rows, not a rank's {B // 2}")
            if layout == "tp_only" and x["gathered_peak"] != 0:
                raise AssertionError(f"{path} rank {r['rank']}: {x['gathered_peak']} weight bytes gathered over "
                                     "\"data\"")
        if worst > NEAR_TIE:
            raise AssertionError(f"{path}: a served token is {worst} below the unsharded steps' max logit")
        paths[path] = ({k: sum(r["serve"][arch]["launches"][k] for r in ranks) for k in ranks[0]["serve"][arch]["launches"]},
                       {k: sum(r["serve"][arch]["routes"][k] for r in ranks) for k in ranks[0]["serve"][arch]["routes"]})
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")
    return flash_rows, bwd_rows, paths, ranks


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.configs import zamba2_7b_instruct as get_zamba2
    from repro_torch.kernels import _build

    with phase("environment"):
        card = card_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"  card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
              f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    with phase("build"):
        info = _build.build()
        print(f"  built {info.library.name} in {info.seconds:.1f}s")
        for line in info.ptxas_log.splitlines():
            if "entry function" in line or "Used" in line or "spill" in line or line.startswith("=="):
                print("   ", line.strip())
    full, reduced = get_config("qwen3-1.7b"), get_reduced("qwen3-1.7b")
    moe_full, moe_reduced = get_config("olmoe-1b-7b"), get_reduced("olmoe-1b-7b")
    with phase("kernels"):
        rows = check_kernels(full)
        rows_g1 = check_kernels(moe_full)
        moe_rows, moe_ulps = check_moe_routing(moe_full)
        flash_family = check_flash_family_shapes()
    rng = np.random.default_rng(SEED)
    prompts = {rid: [int(t) for t in rng.integers(1, full.vocab - 1, size=n)] for rid, n in enumerate(PROMPT_LENS)}
    with phase("serving"):
        counts, routes = serve(full, reduced, card, prompts)
    torch.cuda.empty_cache()  # qwen3's weights and pools are gone with serve()'s frame
    with phase("serving, MoE"):
        counts_moe, routes_moe = serve(moe_full, moe_reduced, card, prompts)
    torch.cuda.empty_cache()
    counts_family, family_bounds = {}, {}
    with phase("serving, other families"):
        for arch in FAMILY_ARCHS:
            counts_family[arch], family_bounds[arch] = serve_family(get_config(arch), card)
            torch.cuda.empty_cache()
    with phase("serving, zamba2"):
        zamba2_rows = check_zamba2_kernels(get_zamba2())
        counts_zamba2 = serve_zamba2(card)
    torch.cuda.empty_cache()
    with phase("training"):
        flash_backward = check_flash_backward()
        counts_train, routes_train, step0 = train(card)
    torch.cuda.empty_cache()
    with phase("distribution"):
        counts_sharded, routes_sharded = distribution(card, step0)
    torch.cuda.empty_cache()
    with phase("split training"):
        flash_split, tc_split, split_ranks = split_training(card, step0)
    torch.cuda.empty_cache()
    del step0
    with phase("sharded serving"):
        counts_serve, routes_serve, serve_ranks = sharded_serving(card)
    torch.cuda.empty_cache()
    with phase("split families"):
        family_paths, family_ranks = split_families(card, family_bounds)
    torch.cuda.empty_cache()
    with phase("layout profiles"):
        layout_flash, layout_bwd, layout_paths, layout_ranks = layout_profiles(card)
    torch.cuda.empty_cache()
    family_paths.update(layout_paths)
    kernels = []
    keys = ("ms", "device_ms", "device_ops", "plain_ms", "plain_device_ms", "plain_device_ops", "library_ms",
            "library_device_ms")

    def by_path(name):
        return {full.name: counts[name], moe_full.name: counts_moe[name],
                **{arch: c[name] for arch, c in counts_family.items()}, ZAMBA2_ARCH: counts_zamba2[name],
                f"train {TRAIN_ARCH}": counts_train[name], SHARDED_PATH: counts_sharded[name],
                SPLIT_PATH: flash_split if name == "flash_attention" else 0,
                SERVE_1X1_PATH: counts_serve[name],
                SERVE_PATH: sum(r["launches"][name] for r in serve_ranks),
                **{path: c[name] for path, (c, _) in family_paths.items()}}

    for name in ("paged_attention", "log_compact", "kv_log_append", "flash_attention"):
        r = rows[name]
        entry = {
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"], "device_ops": r["device_ops"],
            "plain_device_ms": r["plain_device_ms"], "plain_device_ops": r["plain_device_ops"],
            "library_device_ms": r["library_device_ms"],
        }
        if "shape" in r:
            entry["shape"] = r["shape"]
        g1 = rows_g1[name]
        extra = r.get("extra", []) + [dict(g1, shape=f"{moe_full.name}, group size 1: {g1.get('shape', 'with the write log')}")]
        extra += [dict(x, shape=f"{moe_full.name}, group size 1: {x['shape']}") for x in g1.get("extra", [])]
        if name == "flash_attention":
            extra += flash_family + layout_flash
        extra += zamba2_rows[name]
        entry["extra"] = [{"shape": x["shape"], "max_abs_err": x["max_abs_err"], "bound_ms": x["bound"][0],
                           "bound_by": x["bound"][1], **{k: x[k] for k in keys}} for x in extra]
        entry["launches_by_path"] = by_path(name)
        kernels.append(entry)
    kernels[0]["launches_per_call"] = 2
    kernels[2]["ulps"], kernels[2]["tol_ulps"] = rows["kv_log_append"]["ulps"], TOL_EPILOGUE_ULPS
    kernels[2]["ulps_group_size_1"] = rows_g1["kv_log_append"]["ulps"]
    kernels[3]["tensor_core_launches"] = routes["tensor_core"]
    kernels[3]["tensor_core_launches_by_path"] = {full.name: routes["tensor_core"], moe_full.name: routes_moe["tensor_core"],
                                                  f"train {TRAIN_ARCH}": routes_train["tensor_core"],
                                                  SHARDED_PATH: routes_sharded["tensor_core"], SPLIT_PATH: tc_split,
                                                  SERVE_1X1_PATH: routes_serve["tensor_core"],
                                                  SERVE_PATH: sum(r["routes"]["tensor_core"] for r in serve_ranks),
                                                  **{path: r["tensor_core"] for path, (_, r) in family_paths.items()}}
    kernels[3]["launches_per_train_step"] = TRAIN_FLASH_PER_STEP
    kernels[3]["split_launches_per_rank_per_step"] = {f"rank {r['rank']}": [x["flash"] for x in r["steps"]]
                                                      for r in split_ranks}
    kernels[3]["split_shape_per_rank"] = FLASH_SPLIT_SHAPE[0] + ": (1, 4096, 8, 128) / KV 4 causal"
    kernels[3]["serve_launches_per_rank"] = {f"rank {r['rank']}": r["launches"]["flash_attention"] for r in serve_ranks}
    kernels[3]["serve_shape_per_rank"] = {f"rank {r['rank']}": r["shapes"] for r in serve_ranks}
    kernels[3]["split_family_shapes_per_rank"] = {
        f"{part} split 1x2 {arch} rank {r['rank']}": {f"q {q} / KV {kv} of {n_kv}": n for (q, kv, n_kv), n in
                                                      r[f"{part}_shapes"].items()}
        for arch, rs in family_ranks.items() for r in rs for part in ("serve", "train")}
    kernels[3]["layout_launches_per_rank"] = {
        f"train dp 1x2 {LAYOUT_ARCH} rank {r['rank']}": r["train_launches"]["flash_attention"] for r in layout_ranks}
    kernels[3]["layout_launches_per_rank"].update({
        f"serve {layout} {shape[0]}x{shape[1]} {arch} rank {r['rank']}": r["serve"][arch]["launches"]["flash_attention"]
        for arch, layout, shape in LAYOUT_SERVE for r in layout_ranks})
    # moe_routing: the decode-shape moe_ffn call first, then each kernel and prefill
    first = next(r for r in moe_rows if r["kernel"] == "moe_ffn" and r["T"] == MOE_ROUTING_ROWS[0])
    rest = [r for r in moe_rows if r is not first]
    kernels.append({
        "name": "moe_routing", "route": "cuda", "source": "src/repro_torch/csrc/moe_routing.cu",
        "replaces": REPLACES["moe_routing"], "launches": counts_moe["moe_routing"], "shape": first["shape"],
        "max_abs_err": first["max_abs_err"], "bound_ms": first["bound"][0], "bound_by": first["bound"][1],
        **{k: first[k] for k in keys},
        "extra": [{"shape": x["shape"], "max_abs_err": x["max_abs_err"], "bound_ms": x["bound"][0],
                   "bound_by": x["bound"][1], **{k: x[k] for k in keys}} for x in rest],
        "launches_by_path": by_path("moe_routing"), "launches_per_moe_layer_call": 5,
        "ulps": {str(T): u for T, u in moe_ulps.items()},
        "tol_ulps": {"gates_fp32": TOL_MOE_GATE_ULPS, "epilogue_bf16": TOL_MOE_EPILOGUE_ULPS},
    })
    for name, source in (("mamba_step", "mamba_step"), ("rms_norm_rows", "mamba_step"), ("ssd_scan", "ssd_scan")):
        first, *rest = zamba2_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}.cu", "replaces": REPLACES[name],
            "launches": counts_zamba2[name], "shape": first["shape"], "max_abs_err": first["max_abs_err"],
            "ulps": first["ulps"], "bound_ms": first["bound"][0], "bound_by": first["bound"][1],
            **{k: first[k] for k in keys},
            "extra": [{"shape": x["shape"], "max_abs_err": x["max_abs_err"], "ulps": x["ulps"],
                       "bound_ms": x["bound"][0], "bound_by": x["bound"][1], **{k: x[k] for k in keys}} for x in rest],
            "launches_by_path": by_path(name),
        })
    kernels[3]["backward"] = [{"shape": x["shape"], "route": "pytorch ops (flash_attention_bwd)",
                               "max_abs_err": x["max_abs_err"], "max_rel_err": x["max_rel_err"],
                               "bound_ms": x["bound"][0], "bound_by": x["bound"][1],
                               **{k: x[k] for k in keys}} for x in flash_backward + layout_bwd]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
