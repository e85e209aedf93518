#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device     needs torch.cuda; prints the card's name and power limit
  2. build      compiles every CUDA source of src/repro_torch with nvcc,
                one nvcc per source, all at once
  3. kernels    each kernel against its plain PyTorch version at n = 2**28
                with adversarial groups and blocks (sign: words and decode
                exact, scales <= 2 ulp; block top-K, sign_pack and
                block_topk: every output bit for bit, f32 and bf16 values,
                ef_topk_fused and topk_pack also with a coding rank's
                budget k_send < k, block_topk at B in {128, 256, 512} and
                k in {8, 32}), then again at the slice's n (past 2**31) in
                the train step's buffer layout, chunk by chunk, and timed
                there with CUDA events (beside them, as a yardstick only,
                torch.topk of |x| per block: not the same function, its
                tie order differs); the sign and block top-K kernels also
                on the training driver's wire at its n, held and timed the
                same way (ef_sign_fused and sign_decode_reduce at group
                32; ef_topk_fused at block 64, k 8, with each rank's
                budget k_send 8, 8, 3, 1 and a straggler, then
                topk_decode_reduce over those four rows).
                topk_decode_reduce also at small n on the shapes its tile
                plan handles inside the kernel (a partial last tile, fewer
                blocks than a tile, more senders than ring stages, nb*k
                odd with rows off 16-byte granules, one block, an all-zero
                mask) at every B, f32 and bf16 values, and beside each of
                its timings a yardstick of scatter_add_ calls, one per
                sender and chunk (never called by the port).  flash_attention
                within its stated tolerance of its plain version (f32: 2e-4 relative + 2e-5; bf16: one
                bf16 ulp) over an adversarial sweep (hd 16/64/288, groups
                1/2/4, softcap 0/50 with scores far past it, window
                0/1/64/S, S 1/1000/4096, the largest raw score of most
                rows at a masked position, f32 on the CUDA-core kernel and
                bf16 on the tensor-core kernel, each case on its route;
                then the served archs' head widths hd 80 and 128 at groups
                1/2/4/6/7/8 and hd 64 at groups 6/7/8, S 1/1000/4096,
                softcap 0 and 50 with q_scale 100, window 0/64),
                then at the serve slice's global and local layer shapes
                (B 32, H 8, Hkv 4, S 8192, hd 288, bf16, softcap 50,
                window 0 and 4096) against the plain version run per
                (batch, kv head), and timed there, beside one library
                call of the same function (flex_attention, compiled; never
                called by the port); ptxas's registers and spills of the
                tensor-core kernel are printed, and a spill fails.  The
                global top-K route (rounds of topk_pack, one block of n / 4
                per chunk, k = 16) at the slice's n on adversarial chunks
                (a tie at the k-th split across far-apart blocks, an
                all-zero chunk, fewer than k nonzeros, -0.0, denormals)
                against the stable sort of whole chunks, bit for bit, then
                timed against one pass over g, e and e' (12 B/coord)
  3b. init      theta0 from JAX's key (C13): the smoke config's theta0
                on the card equals the CPU's bit for bit; gemma2-2b's
                2,660,228,352 draws on the card (timed), and on its slices
                (all of layer 0's wq, the first and last 4096 rows of the
                token table, layer 13's w_down) equal numpy's draws of the
                same counters (`prng.normal_range`, every core)
  4. reference  the f32 smoke-size train step on the card against the CPU
                (repro_torch/launch/device_parity.py) on the sign wire, the
                block top-K wire and the block top-K wire with per-rank
                budgets, in cocoef and in coco mode, then the dense wire
                (f32, bf16, coco), global top-K (cocoef, coco) and dense
                mode: the full step within stated tolerances, stage 2 on
                injected gradients bit for bit (in the coco and dense modes
                e untouched), and the configurations of phase 7 (two
                buckets in both schedules, phase 2 in bf16 and re-packed
                on the sign wire) and of the dtypes phase (bf16 theta and
                e on sign and budgeted block top-K, in cocoef and coco
                mode; bf16 e alone on block top-K); the smoke-size serving
                path (prefill + 4 decode steps, f32 and bf16) on the card
                against the CPU (`serve_parity`), then the same for each
                of the nine other archs (their caches: KV and MLA rings,
                Mamba2 and xLSTM states; each device decoding from its
                own caches; in bf16 the MoE archs routed by the CPU's
                gate ids; in f32 once more with every cache in f32); the
                smoke configs of the
                new archs (phi3, nemotron, qwen, llava, musicgen on block
                top-K, olmoe, deepseek, zamba2, xlstm on block top-K) card
                against CPU the same way, and the smoke
                olmoe's MoE layer forward and backward twice on the card,
                bit for bit and without a host sync (`moe_repeat`), and
                the smoke deepseek, zamba2 and xlstm losses and backward
                passes in bf16 without a host sync (`loss_no_sync`)
  5. parity     the parity gate (`launch/parity.py`) on the card: at JAX's
                parity sizes (linreg dim 1024, group 32, block 64, k 4,
                N = 4, d = 2, p = 0.25, 2 shards, T = 20) and at dim
                2**22 with the slice's wire (group 512; k 8 of 256;
                gamma scaled by 1024 / dim), for sign, block top-K and
                identity: the reference loop on the card equals the same
                loop on the CPU bit for bit, and `run_parity` (the loop
                against the one-device step) is bit-exact for buckets
                {1, 2} x {serial, pipelined}, with exactly the step's
                kernel launches
  6. train      the slice: gemma2-2b at full width, N = 4 coding ranks on
                the card, d = 2.  Sign wire g = 512: 3 COCO-EF steps, then
                3 COCO steps (mode "coco", no error feedback) on the same
                setup; then, with that setup freed, the block top-K wire
                (k = 8, B = 256, f32 values): 3 COCO-EF steps, 2 with the
                per-rank budgets k = (8, 8, 4, 2), 3 COCO steps and 2 COCO
                steps with the budgets, on the same buffers.  Then, each
                setup freed before the next, 3 steps of each path of: the
                dense wire (compressor "identity": f32, bf16, and coco),
                global top-K (compressor "topk": cocoef and coco) and dense
                mode (the SGC baseline, no error vectors allocated).  The
                kernel launch counts are reset just before each path and
                read just after: 4 x steps local steps (or packs) and one
                decode per step, through the path's kernels only (the
                budgets ride ef_topk_fused in COCO-EF mode, topk_pack in
                COCO mode; global top-K launches topk_pack once a round of
                its selection, 4 x rounds a step; the dense wire and dense
                mode launch none: JAX has no kernel for them); a COCO path
                must leave the error vectors' bits as they were, and no
                path launches flash_attention.  Each step prints its
                seconds, kernel ms and launches, each path its peak memory.
                The first setup draws JAX's theta0; later f32 setups of
                phases 6, 7 and 13 copy it from the host (`init_state`)
  7. buckets    gemma2-2b at full width and depth, N = 4 on the card, one
                setup at a time: the sign wire in two buckets (stage 2 on
                seeded injected gradients in both schedules must give the
                same ghat and e bits, then 3 pipelined and 2 serial
                steps), block top-K in two buckets (2 pipelined steps),
                the sign wire with phase 2 in bf16 and re-packed on the
                sign wire (2 steps each); exact launch counts per path
                (phase 2's re-pack is one sign_pack a bucket), stage-2 ms
                per step, and a peak no higher than the wire's path in
                phase 6 (but for the wider padding)
  8. nccl       one `nccl` process group of world size 1 (file:// init
                under build/): the process-group update on CUDA tensors
                (sign, block top-K, two buckets, pipelined) equals the
                one-device update bit for bit.  N = 4 over NCCL needs
                four cards
  9. driver     the training driver (`python -m repro_torch.launch
                .train_e2e`'s `run`, its coding overrides: group 32, block
                64, k 8) on gemma2-2b at full width, N = 4 on the card, one
                run at a time: 4 steps at full depth with markov stragglers
                (p 0.25) and the elastic coding plane (masks, replans, step
                seconds, stage-2 kernel ms and the peak printed; the same
                flags on the CPU give the same masks, allocations and batch
                weights), 2 block top-K steps at full depth with the
                budgets solved for uplinks of 10, 10, 5 and 2.5 Gbit/s,
                then crash and resume at 2 layers: 4 steps straight
                against 2 steps, a checkpoint (JAX's format, raw), every
                tensor dropped, a restore into a fresh setup and 2 steps,
                theta and e hashed equal (the file's bytes and the seconds
                to save and restore printed); between those, the driver's
                last three flags at full depth: `--plan auto --metrics
                --prefetch 2`, markov p 0.25, 4 steps (the card's plan
                must be the CPU planner's pick; the JSONL and the Chrome
                trace pass the port's validators; batch wait, spans, the
                StepTimer's prediction and the peak printed), then the same
                plan without --metrics (the same theta and e bits; the
                frame's ms a step is the difference); and at 2 layers
                `--prefetch 2` against synchronous batches (markov,
                elastic, 4 steps: theta and e hashed equal); exact launch
                counts per run
 10. families   every family beyond the dense one at full width, one
                setup at a time (FAMILY_CELLS): olmoe-1b-7b (64 experts
                of ff 1024, top 8, d 2048, vocab 50304) at depth
                OLMOE_LAYERS of 16 (four f32 error vectors of the full
                depth would need 188 GB) and deepseek-v2-lite-16b (MLA of
                rank 512 with q.k 192 and v 128 wide, 64 experts of ff
                1408, top 6, 2 shared, a dense block0 of ff 10944, vocab
                102400) at depth DEEPSEEK_LAYERS of 27 (block0 and 4 MoE
                blocks; the full depth's 15.7e9 parameters need about
                400 GB) through the driver (`train_e2e.run`, --arch, its
                sign wire at g 32, iid stragglers at the arch's p 0.1), N
                = 4 on the card, 4 steps each; musicgen-large (48 layers:
                LayerNorm, gelu, the embeddings input, an untied head) at
                full depth and xlstm-1.3b at XLSTM_LAYERS of 48 (2 of its
                6 groups of 7 mLSTM blocks of head width 1024 and an
                sLSTM block of 512 sequential steps; the dtypes phase's
                time) through `build_train_setup` and `train_step` on
                block top-K (k 8 of 256), zamba2-2.7b at ZAMBA2_LAYERS of
                54 (3 of its 9 groups of 6 Mamba2 blocks, each followed by
                the one shared attention block) the same way on its sign
                wire (g 512), 3 steps each.  Each prints its steps'
                seconds, stage-2 ms and launches, theta0's seconds, its
                peak memory and (olmoe, deepseek) the assignments its MoE
                layers dropped; the
                launch counts must be exact and the losses finite.  Then
                the kernels of every path at its shapes, held against
                their plain versions and timed as on the driver's wire:
                ef_sign_fused and sign_decode_reduce at olmoe's and
                deepseek's n (group 32) and zamba2's (group 512),
                ef_topk_fused (every rank, one a straggler) and
                topk_decode_reduce at musicgen's and xlstm's n, block 256,
                k 8.  The "setup" cells' theta after training goes to
                the host for phase 12
 11. serve      with the train setups freed: gemma2-2b at full width and
                depth serves 3 requests, each 32 seeded prompts of 8192
                tokens prefilled (26 flash_attention launches, one per
                layer, all on the tensor-core route) then 32 greedy
                decode steps (no kernel launch);
                then request 0 again, which must give the same tokens and
                logits bit for bit.  Prints per request the prefill
                seconds, decode ms per token (and the host's time to
                enqueue the decode steps), tokens per second and the peak
                memory
 12. serve the other archs, one setup at a time (SERVE_CELLS):
                phi3-medium-14b at full width and depth (40 layers, JAX's
                theta0 drawn on the card) serves PHI3_REQUESTS request of
                1 x 32768 tokens (PREFILL_32K's S; B cut from 32 by
                memory) and request 0 again; olmoe-1b-7b at 6 of 16
                layers and deepseek-v2-lite-16b at 5 of 27 (theta0),
                musicgen-large (the embeddings input), zamba2-2.7b on
                4 x 4096 and xlstm-1.3b on 4 x 2048 at phase 10's depths
                (phase 10's theta) serve 1 request and request 0 again:
                each
                prefill, then 32 decode steps (greedy; musicgen fed seeded
                embeddings), one flash_attention launch per GQA attention
                layer on the tensor-core route (phi3 40, olmoe 6, zamba2's
                shared block 3, musicgen 48, none for MLA and the xLSTM),
                none in the decode, the caches' positions the ring JAX
                writes, finite logits, request 0 again bit for bit; prints
                theta's seconds, prefill seconds, decode and enqueue ms per
                token, the peak memory (at most 80 GB) and phi3's decode
                floor (f32 theta read once a step; with the bf16 casts'
                writes).  Then B8 at each GQA cell's layer shape against
                the plain version, timed beside the library call
                (flex_attention's own tiles, the fastest at these widths
                in `tools/flex_tiles.py --cells`);
                and `launch.serve_batched` on the card: its default run
                (phi3's smoke config, bf16) under --metrics (records and
                trace validated) and its f32 run, tokens equal to the
                CPU's
 13. dtypes     bf16 theta and bf16 error vectors (TrainRun.param_dtype and
                ef_dtype).  After phase 3's checks, the kernel instances
                that read bf16 g and e at the slice's n in the train
                layout, bit for bit against their plain versions (words,
                index sets, values, scales, bf16 e') and timed:
                ef_sign_fused on bf16 g and e and on f32 g with bf16 e,
                ef_topk_fused on bf16 g and e (k_send 8, 8, 3, 1 and a
                straggler; timed at 8 and 1), sign_pack and topk_pack on
                bf16 g with gamma folded in (COCO's gamma*g).  After phase
                10: gemma2-2b at full width and depth with
                TrainRun(param_dtype="bfloat16", ef_dtype="bfloat16"),
                N = 4, theta0 JAX's bf16 theta0: 5 sign steps and 2 sign
                COCO steps, then 5 block top-K steps, 2 budgeted and 2
                COCO, then (f32 theta) 2 sign steps with ef_dtype alone,
                one setup at a time, exact launch counts, step seconds,
                stage-2 ms and peaks printed; olmoe-1b-7b at full width
                and OLMOE_BF16_LAYERS of 16 layers (bf16 state: 74.8 GB)
                through build_train_setup, 3 sign steps at g 32.  Inside
                phase 12, right after phi3's cell: phi3-medium-14b at full
                width and depth with bf16 theta (phi3's f32 theta0 rounded
                once, held on the host; three leaves checked bit for bit
                against a bf16 init) serves PHI3_BF16_BATCH x 32768 tokens
                and request 0 again bit for bit, its decode floor bf16
                theta read once.  The kernel table gets a row for each
                instance, its launches counted on these paths
 14. examples   after the dtypes phase, before phase 11: the paper's Task
                B (`data.tasks.classification_task`, the small CNN) in
                one trial of fig7's protocol (N = M = 100, d 2, iid p
                0.6): COCO-EF with GroupedSign at gamma 3e-3 and Unbiased
                with StochasticSign at 1e-3, EXAMPLE_T steps each through
                the reference loop, F and the test accuracy printed at
                steps 0, 100, 200 and the last, seconds a step; the first
                EXAMPLE_CHECK steps' F within EXAMPLE_RTOL of the CPU's,
                the gradients at theta0 within it of the CPU's and the
                same bits with TF32 switched on globally.  JAX's
                quickstart (`launch.quickstart.main`, 301 steps of both
                runs): F(theta) equal at every printed step to the CPU's
                run, made in a child process while Task B runs.
                `nn.layers.prefill_kv` and `mla_prefill` card against CPU
                at smoke widths.  JAX's elastic_restart example
                (`launch.elastic_restart.run`) at full width, olmoe-1b-7b
                at ELASTIC_LAYERS of 16 layers: ELASTIC_STEPS sign steps
                (g 32) on 4 coding ranks, a checkpoint under the temp dir,
                ELASTIC_STEPS on 2 ranks; exact launch counts, phase 1's
                surviving e rows hashed equal to the restored ones and
                the rescaled rows equal to those, seconds a step, save
                and restore seconds, the file's bytes and the peak
                printed; then ef_sign_fused at its n and
                sign_decode_reduce at N = 4 and N = 2 held against their
                plain versions and timed ("elastic_wire" in the kernel
                table)
15. dryrun     the production-mesh dry run (`launch.dryrun`, host work on
                the meta device): `run_cell` for gemma2-2b train_4k on
                both meshes, qwen1.5-110b train_4k on the multi-pod mesh
                (FSDP, coding over pod only) and phi3-medium-14b
                decode_32k on the single-pod mesh, each record's line
                printed and its status ok.  Inside phase 6, with the
                sign setup still on the card after its paths: the card's
                count hold, one more real sign step (gemma2-2b, full
                width and depth, N = 4, seq 512, batch 4) under
                `op_cost.OpCounter` on the card and the same step on a
                meta-device setup: the same dot flops and the same kernel
                charges (ef_sign_fused x 4, sign_decode_reduce x 1:
                launches, bytes, operations), exactly; then stage 1 alone
                (the four ranks' forward and backward, host clock ending
                in a synchronise) timed twice, its dot TFLOP/s printed
                against the peaks of its dtypes beside the card's name
                and power limit
 16. shard      right after phase 11, on its theta (moved to the host, no
                new draw) and its request 0: gemma2-2b at full width and
                depth served sharded in-process on the card
                (`launch.mesh.local_mesh`, `build_serve_setup(...,
                mesh=)`) on (data=1, model=4) and (data=2, model=2), one
                mesh at a time: request 0's prompt (32 x 8192, the batch
                over data) prefilled, then 32 decode steps fed phase 11's
                greedy tokens, twice.  It holds (a) every device's bytes
                (theta shard, cache blocks, int32 token blocks) equal to
                `serve_specs`' on that mesh, exactly; (b) flash_attention
                26 times a device, 104 a sharded prefill, all on the
                tensor-core route, none in the decode; (d) every step's
                logits within SHARD_TOL of phase 11's (of their largest
                magnitude: half the one-device bf16 serve's own gap to
                f32, `tools/shard_gap.py`) and every greedy token equal
                to phase 11's; (e) the second run's logits and
                caches the first's bits; the cache positions the ring JAX
                writes.  Prints per mesh the prefill seconds, decode and
                enqueue ms a token, the gap, the tokens equal and the
                peak; then (c) B8 at one device's shape of each mesh (B
                32, H 2, Hkv 1; B 16, H 4, Hkv 2; both windows) against
                the plain version, timed beside flex_attention
Then it prints the kernel table as one JSON line, the card's
`nvidia-smi` name and power limit, and as the last line
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
T0 = time.perf_counter()  # settle() prints the seconds since

STEPS = 3                 # cut from 5 for the time limit
BUDGET_STEPS = 2
NEW_STEPS = 3             # each path of the identity, topk and dense setups
N_CODE = 4
SEQ_LEN, GLOBAL_BATCH = 512, 4
GROUP = 512
BLOCK, K = 256, 8                 # the block top-K wire of CodingPlan
TOPK_K = 64               # CodingPlan.topk_k: global top-K's budget
K_BUDGETS = (8, 8, 4, 2)
TOPK_BLOCKS = (128, 256, 512)     # block_topk's kernel block sizes
CHECK_N = 1 << 28
CHUNK = 1 << 28           # the plain versions run in chunks this long
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet, at 700 W
F32_OPS_PER_S = 67e12         # H100 SXM data sheet, f32 outside tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM data sheet, bf16 dense tensor cores
MAX_ULP = 2
SERVE_BATCH, SERVE_SEQ = 32, 8192  # PREFILL_32K's batch, S cut to 8192
NEW_TOKENS = 32
REQUESTS = 3
SERVE_SEED = 0
# flex_attention's own tile choice needs 256 KiB of shared memory at hd
# 288 (padded to 512), over the card's 227 KiB: the fastest of the tiles
# tools/flex_tiles.py tries
FLEX_OPTIONS = {"BLOCK_M": 64, "BLOCK_N": 64, "num_stages": 1,
                "num_warps": 8}
LIBRARY_MAX_ABS_ERR = 0.0625  # flex_attention rounds p to bf16 for p.v
PARITY_T = 20
# run_parity at JAX's parity sizes, then at the Notes' n per rank with the
# slice's wire knobs and gamma scaled by 1024 / dim: the curvature of the
# linear regression grows with dim, and at JAX's 2e-6 the loop overflows
# to NaN within 20 steps at dim 2**22
PARITY_SIZES = ((1024, {}), (1 << 22, {"group_size": GROUP,
                                        "block_size": BLOCK,
                                        "k_per_block": K,
                                        "gamma": 2e-6 * 1024 / (1 << 22)}))
BUCKETS = 2
DRIVER_STEPS = 4          # the driver's elastic markov run, full depth
                          # (cut from 6 for the time limit)
DRIVER_BUDGET_STEPS = 2
DRIVER_UPLINKS = "10,10,5,2.5"    # Gbit/s a rank: k_send = DRIVER_K_BUDGETS
DRIVER_K_BUDGETS = (8, 8, 3, 1)
RESUME_LAYERS = 2         # crash and resume: full width, depth cut
PREFETCH_LAYERS = 2       # prefetched against synchronous: depth cut
OLMOE_LAYERS = 6          # olmoe-1b-7b's depth on one card (of 16)
OLMOE_STEPS = 4
MUSICGEN_STEPS = 3
DEEPSEEK_LAYERS = 5       # deepseek-v2-lite-16b's depth on one card (of
DEEPSEEK_STEPS = 4        # 27): block0 and 4 MLA + MoE blocks
ZAMBA2_STEPS = 3
XLSTM_STEPS = 3
# depths cut to make room for the dtypes phase in the time limit (full
# depth: 54 and 48 layers, 35 and 76 s of phase 10)
ZAMBA2_LAYERS = 18        # 3 of zamba2-2.7b's 9 groups
XLSTM_LAYERS = 16         # 2 of xlstm-1.3b's 6 groups
PHI3_REQUESTS = 1         # phi3's f32 cell (was 3), then request 0 again
NEW_ARCHS = ("phi3-medium-14b", "nemotron-4-15b", "qwen1.5-110b",
             "llava-next-34b", "musicgen-large", "olmoe-1b-7b",
             "deepseek-v2-lite-16b", "zamba2-2.7b", "xlstm-1.3b")
BLOCK_TOPK_ARCHS = ("musicgen-large", "xlstm-1.3b")
LATER_ARCHS = ("deepseek-v2-lite-16b", "zamba2-2.7b", "xlstm-1.3b")
# phase 10's cells at full width, one at a time: key -> (arch, driven by
# the "driver" (train_e2e.run: its sign wire, g 32) or a "setup"
# (build_train_setup + train_step on the arch's CodingPlan), depth (None:
# full), steps, compressor)
FAMILY_CELLS = {
    "olmoe": ("olmoe-1b-7b", "driver", OLMOE_LAYERS, OLMOE_STEPS, "sign"),
    "musicgen": ("musicgen-large", "setup", None, MUSICGEN_STEPS,
                 "block_topk"),
    "deepseek": ("deepseek-v2-lite-16b", "driver", DEEPSEEK_LAYERS,
                 DEEPSEEK_STEPS, "sign"),
    "zamba2": ("zamba2-2.7b", "setup", ZAMBA2_LAYERS, ZAMBA2_STEPS, "sign"),
    "xlstm": ("xlstm-1.3b", "setup", XLSTM_LAYERS, XLSTM_STEPS,
              "block_topk"),
}
PHI3_BF16_BATCH = 4       # 29.3 GB of bf16 theta + 4 x 6.71 GB of caches
# phase 12's cells, one at a time: key -> (arch, depth (None: full),
# batch, prompt length, requests before request 0 again, where theta
# comes from: "init" (JAX's theta0 drawn on the card) or phase 10's cell
# of that key (its theta after training, held on the host))
SERVE_CELLS = {
    "phi3": ("phi3-medium-14b", None, 1, 32768, PHI3_REQUESTS, "init"),
    "phi3 bf16": ("phi3-medium-14b", None, PHI3_BF16_BATCH, 32768, 1,
                  "phi3"),
    "olmoe": ("olmoe-1b-7b", OLMOE_LAYERS, 4, 4096, 1, "init"),
    "deepseek": ("deepseek-v2-lite-16b", DEEPSEEK_LAYERS, 4, 4096, 1,
                 "init"),
    "musicgen": ("musicgen-large", None, 4, 4096, 1, "musicgen"),
    "zamba2": ("zamba2-2.7b", ZAMBA2_LAYERS, 4, 4096, 1, "zamba2"),
    "xlstm": ("xlstm-1.3b", XLSTM_LAYERS, 4, 2048, 1, "xlstm"),
}
# phase 12's cells with another parameter dtype than the config's (the
# dtypes phase's phi3 cell: its theta is phi3's f32 theta0 rounded once)
SERVE_PARAM_DTYPE = {"phi3 bf16": "bfloat16"}
HELD_THETA = {}           # phase 10's "setup" cells' theta, on the host
THETA0_HOST = {}          # (config, flat size, seed) -> f32 theta0 drawn
#   by the phases' first such train setup, on the host (`init_state`)
# the dtypes phase: gemma2-2b with bf16 theta and e (TrainRun.param_dtype,
# ef_dtype) on each wire and mode, then olmoe-1b-7b at the depth bf16
# state allows: 17 B a coordinate (theta, g 2 each, four e 8, ghat 4,
# the sign payload at g 32 about 1), 74.8 GB at 10 layers, 82.0 at 11
DTYPE_STEPS, DTYPE_SHORT_STEPS = 5, 2
OLMOE_BF16_LAYERS = 10
OLMOE_BF16_STEPS = 3
BF16 = {"param_dtype": "bfloat16", "ef_dtype": "bfloat16"}
# the examples phase: Task B's trial (fig7's T), its steps held against
# the CPU and their relative tolerance; the elastic restart's olmoe-1b-7b
# depth (the driver's crash-and-resume depth: about 1.05e9 parameters,
# about 30 GB of f32 state on 4 ranks and a 21 GB checkpoint) and steps a
# phase
EXAMPLE_T = 300
EXAMPLE_CHECK = 10
EXAMPLE_RTOL = 1e-5
ELASTIC_LAYERS = 2
ELASTIC_STEPS = 3
# flash_attention's sweep beyond hd 16/64/288 x groups 1/2/4: the served
# archs' head widths (hd 128: phi3, nemotron, qwen, llava, olmoe; 80:
# zamba2's shared block; 64: musicgen) and group ratios (6: nemotron, 7:
# llava, 8)
FLASH_EXTRA = [(hd, g) for hd in (80, 128) for g in (1, 2, 4, 6, 7, 8)] + \
    [(64, g) for g in (6, 7, 8)]
INIT_ROWS = 4096          # rows of each end of the token table checked
INIT_LAYER = 13           # the layer whose w_down is checked
INIT_PIECE = 256          # rows a numpy thread draws at a time
FRAME_REPS = 3            # stage 2 timed with and without the frame
HASH_CHUNK = 1 << 26      # position-weighted bit hashes, this many at once
NCCL_N = 1 << 26


def ptxas_summary(report: str) -> list:
    """Per kernel entry of ptxas -v's report: registers at entry and spill
    bytes (the kernels' shared memory is all dynamic, sized at launch)."""
    rows = []
    for line in report.splitlines():
        if "Compiling entry function" in line:
            rows.append({"entry": line.split("'")[1], "registers": None,
                         "spill_bytes": 0})
        elif rows and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            rows[-1]["spill_bytes"] = sum(map(int, nums))
        elif rows and "Used" in line and "registers" in line:
            m = re.search(r"Used (\d+) registers", line)
            rows[-1]["registers"] = int(m.group(1))
    if not rows:
        fail("no ptxas report for the tensor-core flash_attention kernel")
    return rows


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, after one
    warm-up call (CUDA events)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(fn(), its device ms) of one call (CUDA events): for the plain
    versions that take seconds, timed on the call the check uses."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def ulps(a, b):
    import torch
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def spacing(x):
    """One ulp of |x| (f32), denormals included."""
    import torch
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def adversarial_(g, e, G: int, gamma: float) -> None:
    """First groups: all zeros, all -0.0, denormals, exact cancellation."""
    g[:G] = 0.0
    e[:G] = 0.0
    g[G:2 * G] = -0.0
    e[G:2 * G] = -0.0
    sgn = (g[2 * G:3 * G] >= 0).float() * 2 - 1
    g[2 * G:3 * G] = sgn * 1e-40
    e[2 * G:3 * G] = -sgn * 3e-41
    g[3 * G:4 * G] = 1.0
    e[3 * G:4 * G] = -gamma


def compare_ef(torch, want, got, what: str, G: int = GROUP) -> dict:
    """want = the plain (words, scales, c, e'), got = the kernel's (c may
    be None).  Words exact, scales <= MAX_ULP ulp; c and e' exact where
    the scales agree, else within MAX_ULP ulp of the scale (plus one
    rounding of e')."""
    w0, s0, c0, e0 = want
    w1, s1, c1, e1 = got
    if not torch.equal(w0, w1):
        fail(f"{what}: words differ")
    du = ulps(s0, s1)
    if du.max().item() > MAX_ULP:
        fail(f"{what}: scales {du.max().item()} ulp apart")
    same = (du == 0).repeat_interleave(G)
    tol = spacing(torch.maximum(s0, s1)).repeat_interleave(G) * MAX_ULP
    worst = {"max_ulp": du.max().item(), "max_abs_err": 0.0}
    for name, a, b, extra in (("c", c0, c1, 0.0), ("e'", e0, e1, None)):
        if b is None:
            continue
        if not torch.equal(a[same].view(torch.int32),
                           b[same].view(torch.int32)):
            fail(f"{what}: {name} differs where scales agree")
        if extra is None:   # one rounding of e' = acc - c itself
            extra = spacing(torch.maximum(a.abs(), b.abs()))
        if bool(((a - b).abs() > tol + extra).any()):
            fail(f"{what}: {name} beyond the scale-ulp bound")
        worst["max_abs_err"] = max(worst["max_abs_err"],
                                   (a - b).abs().max().item())
    return worst


def merge(a: dict, b: dict) -> dict:
    return {k: max(a[k], b[k]) for k in a}


def check_ef(torch, ref, sp, gen, dev) -> dict:
    gamma = 0.37
    g = torch.randn(CHECK_N, device=dev, generator=gen)
    e = torch.randn(CHECK_N, device=dev, generator=gen) * 0.01
    mag = torch.exp(torch.rand(CHECK_N // GROUP, device=dev, generator=gen)
                    * 25 - 20).repeat_interleave(GROUP)
    g.mul_(mag)
    e.mul_(mag)
    adversarial_(g, e, GROUP, gamma)
    worst = {"max_ulp": 0, "max_abs_err": 0.0}
    for mask in (1.0, 0.0):
        got = sp.ef_sign_fused(g, e, gamma, mask, GROUP, want_c=True)
        torch.cuda.synchronize()
        want = ref.ef_sign_fused_ref(g, e, gamma, mask, GROUP)
        worst = merge(worst, compare_ef(
            torch, want, got, f"ef_sign_fused at n={CHECK_N} (mask={mask})"))
        if mask == 0.0 and not torch.equal(got[3], e):
            fail("ef_sign_fused: a straggler's e changed")
        del got, want
    return worst


def check_decode(torch, ref, sp, gen, dev) -> dict:
    words = torch.randint(0, 2 ** 32, (N_CODE, CHECK_N // 32), device=dev,
                          generator=gen, dtype=torch.int64).to(torch.uint32)
    scales = torch.rand((N_CODE, CHECK_N // GROUP), device=dev,
                        generator=gen)
    scales[0, :4] = 0.0
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
    got = sp.sign_decode_reduce(words, scales, mask, GROUP)
    torch.cuda.synchronize()
    want = ref.sign_decode_reduce_ref(words, scales, mask, GROUP)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail("sign_decode_reduce differs from the sender-order sum")
    return {"max_ulp": 0, "max_abs_err": (got - want).abs().max().item()}


def bill(kernel: str, *args, **kw) -> tuple:
    """(bytes, operations) of one launch of `kernel`: `kernels.cost`'s
    function of the same name, the charge its wrapper makes."""
    from repro_torch.kernels import cost
    c = getattr(cost, kernel)(*args, **kw)
    return c.bytes, c.ops


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def ef_at_slice(torch, ref, sp, gen, dev, n: int, G: int = GROUP) -> dict:
    """ef_sign_fused at the slice's n (past 2**31 elements) and group G in
    the train step's layout: the error is a row of a 2-D buffer updated in
    place and the payload goes into rows of the (N, n/32) and (N, n/G)
    buffers.  Row 0 of `e` keeps the inputs, row 1 is the one the kernel
    updates.  A straggler launch (mask 0, payload row 2) and a live one
    (mask 1, row 1) are held against the plain version chunk by chunk, then
    the live one is timed.  Adversarial groups sit at the start and past
    2**31."""
    gamma = 5e-3
    g = torch.randn(n, device=dev, generator=gen)
    e = torch.empty((2, n), device=dev)
    e[0].normal_(generator=gen)
    mag = torch.exp(torch.rand(n // G, device=dev, generator=gen)
                    * 25 - 20).repeat_interleave(G)
    g.mul_(mag)
    e[0].mul_(mag).mul_(0.01)
    del mag
    for a in (0, n - 4 * G):
        adversarial_(g[a:a + 4 * G], e[0, a:a + 4 * G], G, gamma)
    e[1].copy_(e[0])
    gamma_t = torch.tensor(gamma, device=dev)   # a device scalar, as in
    # the train step: no launch copies it from the host
    words = torch.zeros((N_CODE, n // 32), dtype=torch.uint32, device=dev)
    scales = torch.zeros((N_CODE, n // G), device=dev)
    masks = torch.tensor([1.0, 0.0], device=dev)
    worst = {"max_ulp": 0, "max_abs_err": 0.0}
    for row, m in ((2, masks[1]), (1, masks[0])):
        sp.ef_sign_fused(g, e[1], gamma_t, m, G,
                         out=(words[row], scales[row], e[1]))
        torch.cuda.synchronize()
        what = f"ef_sign_fused at n={n}, g {G} (mask={m.item()})"
        if m.item() == 0.0 and not torch.equal(e[1].view(torch.int32),
                                                e[0].view(torch.int32)):
            fail(f"{what}: a straggler's e changed")
        for i in range(0, n, CHUNK):
            j = min(i + CHUNK, n)
            want = ref.ef_sign_fused_ref(g[i:j], e[0, i:j], gamma_t, m,
                                         G)
            got = (words[row, i // 32:j // 32],
                   scales[row, i // G:j // G], None, e[1, i:j])
            worst = merge(worst, compare_ef(torch, want, got, what, G))
            del want

    ms = cuda_ms(lambda: sp.ef_sign_fused(
        g, e[1], gamma_t, masks[0], G, out=(words[1], scales[1], e[1])),
        10)

    def plain():
        for i in range(0, n, CHUNK):
            ref.ef_sign_fused_ref(g[i:i + CHUNK], e[0, i:i + CHUNK], gamma_t,
                                  masks[0], G)
    plain_ms = cuda_ms(plain, 2)
    moved, ops = bill("ef_sign_fused", n, G)
    b, by = bound(moved, ops)
    return {**worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": by, "gb_per_s": moved / ms / 1e6}


def decode_at_slice(torch, ref, sp, gen, dev, n: int, G: int = GROUP,
                    senders: int = N_CODE) -> dict:
    """sign_decode_reduce at the slice's n and group G over the (N, n/32)
    and (N, n/G) payload buffers of the train step (N = senders, rank 1 a
    straggler): held against the plain version chunk by chunk (exact),
    then timed."""
    words = torch.randint(0, 2 ** 32, (senders, n // 32), device=dev,
                          generator=gen, dtype=torch.int64).to(torch.uint32)
    scales = torch.rand((senders, n // G), device=dev, generator=gen)
    scales[0, :4] = 0.0
    scales[min(2, senders - 1), -4:] = 0.0
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0][:senders], device=dev)
    out = torch.empty(n, device=dev)
    sp.sign_decode_reduce(words, scales, mask, G, out=out)
    torch.cuda.synchronize()
    for i in range(0, n, CHUNK):
        j = min(i + CHUNK, n)
        want = ref.sign_decode_reduce_ref(words[:, i // 32:j // 32],
                                          scales[:, i // G:j // G],
                                          mask, G)
        if not torch.equal(out[i:j].view(torch.int32),
                           want.view(torch.int32)):
            fail(f"sign_decode_reduce at n={n}, g {G} differs from the "
                 f"sender-order sum in [{i}, {j})")
        del want

    ms = cuda_ms(lambda: sp.sign_decode_reduce(words, scales, mask, G,
                                               out=out), 10)

    def plain():
        for i in range(0, n, CHUNK):
            ref.sign_decode_reduce_ref(
                words[:, i // 32:(i + CHUNK) // 32],
                scales[:, i // G:(i + CHUNK) // G], mask, G)
    plain_ms = cuda_ms(plain, 2)
    moved, ops = bill("sign_decode_reduce", senders, n, G)
    b, by = bound(moved, ops)
    return {"max_ulp": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "gb_per_s": moved / ms / 1e6}


def bits(t):
    """Integer view of the same size (floats), so equality is bitwise."""
    import torch
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.uint16: torch.int16}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def same(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(bits(a), bits(b))


def topk_adversarial_(g, e, B: int = BLOCK, K: int = K) -> None:
    """First blocks of B (acc = gamma*g + e): all zeros, all -0.0,
    denormals, K + 1 equal maxima of mixed sign over small values, exactly
    K nonzeros, every |acc| equal."""
    blk = [slice(i * B, (i + 1) * B) for i in range(6)]
    g[blk[0]] = 0.0
    e[blk[0]] = 0.0
    g[blk[1]] = -0.0
    e[blk[1]] = -0.0
    g[blk[2]] = g[blk[2]].sign() * 1e-40
    e[blk[2]] = g[blk[2]] * 0.3
    g[blk[3]] *= 1e-3 / g[blk[3]].abs().max()
    e[blk[3]] = 0.0
    tie = g[blk[3]]
    tie[3:3 + 3 * (K + 1):3] = 2.0
    tie[6:6 + 6 * ((K + 1) // 2):6] = -2.0
    g[blk[4]] = 0.0
    e[blk[4]] = 0.0
    g[blk[4]][5:5 + 7 * K:7] = 1.5
    g[blk[5]] = g[blk[5]].sign()
    e[blk[5]] = 0.0


def compare_topk(got, want, what: str) -> None:
    """got = the kernel's outputs (idx u16, values in the wire dtype,
    scales[, c, e']), want = the plain version's (idx i32, values f32
    holding wire-rounded numbers, ...).  Every output bit for bit."""
    import torch
    idx, val = got[0], got[1]
    if not torch.equal(bits(idx).to(torch.int32) & 0xFFFF, want[0]):
        fail(f"{what}: indices differ")
    if not same(val, want[1].to(val.dtype)):
        fail(f"{what}: values differ")
    for name, a, b in zip(("scales", "c", "e'"), got[2:], want[2:]):
        if a is not None and not same(a, b):
            fail(f"{what}: {name} differ in {int((bits(a) != bits(b)).sum())}"
                 f" entries")


def topk_inputs(torch, gen, dev, n: int, rows: int = 1, B: int = BLOCK,
                k: int = K):
    """g (n,) and e (rows, n), e[r] all equal, of widely varying scales
    over blocks of B, with the adversarial blocks (for k) at the start and
    at the end."""
    g = torch.randn(n, device=dev, generator=gen)
    e = torch.empty((rows, n), device=dev)
    e[0].normal_(generator=gen)
    mag = torch.exp(torch.rand(n // B, device=dev, generator=gen)
                    * 25 - 20).repeat_interleave(B)
    g.mul_(mag)
    e[0].mul_(mag).mul_(0.01)
    del mag
    for a in (0, n - 6 * B):
        topk_adversarial_(g[a:a + 6 * B], e[0, a:a + 6 * B], B, k)
    for r in range(1, rows):
        e[r].copy_(e[0])
    return g, e


def check_topk(torch, ref, tp, gen, dev) -> None:
    """B3 (f32 and bf16 values, mask 1 and 0, with and without a rank's
    budget k_send < k), B6 (with and without the budget) and B4 against
    their plain versions at n = 2**28 on fresh buffers, bit for bit."""
    gamma = 0.37
    g, e = topk_inputs(torch, gen, dev, CHECK_N)
    e = e[0]
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
    for vd in ("float32", "bfloat16"):
        for ks in (K_BUDGETS[3], K):
            for m in (1.0, 0.0):
                got = tp.ef_topk_fused(g, e, gamma, m, K, BLOCK, vd,
                                       want_c=True, k_send=ks)
                torch.cuda.synchronize()
                want = ref.ef_topk_fused_ref(g, e, gamma, m, K, BLOCK, vd, ks)
                compare_topk(got, want, f"ef_topk_fused at n={CHECK_N} "
                             f"({vd}, k_send={ks}, mask={m})")
                if m == 0.0 and not same(got[4], e):
                    fail("ef_topk_fused: a straggler's e changed")
                ef_payload = got[:3]
                del got, want
        budgeted = tp.topk_pack(g, K, BLOCK, vd, k_send=K_BUDGETS[3])
        torch.cuda.synchronize()
        compare_topk(budgeted, ref.topk_pack_ref(g, K, BLOCK, K_BUDGETS[3]),
                     f"topk_pack at n={CHECK_N} ({vd}, k_send="
                     f"{K_BUDGETS[3]})")
        del budgeted
        packed = [tp.topk_pack(x, K, BLOCK, vd) for x in (g, e)]
        torch.cuda.synchronize()
        compare_topk(packed[0], ref.topk_pack_ref(g, K, BLOCK),
                     f"topk_pack at n={CHECK_N} ({vd})")
        senders = [ef_payload, packed[0],
                   tuple(t.clone() for t in ef_payload), packed[1]]
        senders[2][1][:, K_BUDGETS[3]:] = 0        # a budgeted rank's row
        payload = [torch.empty((len(senders),) + t.shape, dtype=t.dtype,
                               device=dev) for t in senders[0]]
        for i, p in enumerate(senders):     # copy_, not stack: u16 rows
            for j in range(3):
                payload[j][i].copy_(p[j])
        got = tp.topk_decode_reduce(*payload, mask, BLOCK)
        torch.cuda.synchronize()
        want = ref.topk_decode_reduce_ref(*payload, mask, BLOCK)
        if not same(got, want):
            fail(f"topk_decode_reduce at n={CHECK_N} ({vd}) differs from "
                 f"the sender-order sum")
        del packed, senders, payload, got, want


def decode_payload(torch, gen, dev, N: int, nb: int, k: int, B: int, vdt,
                   offset: int = 0, budgets=None):
    """Seeded payloads of N senders for topk_decode_reduce: distinct
    in-block positions, values of both signs (a -0.0 among them), scales
    over 2^-14..2^3 with 1.0 (an all-zero block's) in block 0; each
    tensor a contiguous view `offset` elements into its buffer, so that
    its rows start off 16-byte granules; with `budgets`, sender i's values
    past slot budgets[i] are +0, as a budgeted rank's."""
    def view(shape, dtype):
        buf = torch.empty(offset + math.prod(shape), dtype=dtype, device=dev)
        return buf[offset:].view(shape)
    idx = view((N, nb, k), torch.uint16)
    idx.view(torch.int16).copy_(torch.rand(
        (N, nb, B), device=dev, generator=gen).argsort(-1)[..., :k])
    val = view((N, nb, k), vdt)
    val.copy_(torch.randn((N, nb, k), device=dev, generator=gen))
    val[0, 0, 0] = -0.0
    sc = view((N, nb), torch.float32)
    sc.copy_(torch.exp2(torch.rand((N, nb), device=dev, generator=gen) * 17
                        - 14))
    sc[:, 0] = 1.0
    for i, b in enumerate(budgets or ()):
        val[i, :, b:] = 0
    return idx, val, sc


def decode_shape_cases(T: int) -> list:
    """(what, N, nb, k, mask, budgets, element offset) of the small-n
    topk_decode_reduce checks, for tiles of T blocks: a last partial tile
    with the driver's budgets, fewer blocks than a tile with more senders
    than ring stages, nb*k odd with every row off its granule, one
    block of one sender, and an all-zero mask at k 32."""
    return [("a partial last tile, budgets 8, 8, 3, 1", 4, 2 * T + 5, 8,
             (1.0, 1.0, 1.0, 0.0), DRIVER_K_BUDGETS, 0),
            ("fewer blocks than a tile, N 9", 9, T - 3, 8,
             (1.0, 0.0, 0.75, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0), None, 0),
            ("nb*k odd, rows off 16-byte granules", 4, T + 7, 3,
             (1.0, 0.0, 1.0, 1.0), None, 1),
            ("one block, N 1", 1, 1, 1, (1.0,), None, 0),
            ("mask all zero, k 32", 4, T + 1, 32, (0.0,) * 4, None, 3)]


def check_decode_shapes(torch, ref, tp, gen, dev) -> int:
    """topk_decode_reduce against its plain version, bit for bit, at small
    n on the shapes a tile plan must handle inside the kernel
    (`decode_shape_cases`), at every block size and in f32 and bf16.
    Returns the number of cases."""
    cases = 0
    for B in tp.SUPPORTED_BLOCK_SIZES:
        for what, N, nb, k, m, budgets, off in decode_shape_cases(
                tp.DECODE_TILE // B):
            for vdt in (torch.float32, torch.bfloat16):
                idx, val, sc = decode_payload(torch, gen, dev, N, nb, k, B,
                                              vdt, off, budgets)
                mask = torch.tensor(m, device=dev)
                got = tp.topk_decode_reduce(idx, val, sc, mask, B)
                torch.cuda.synchronize()
                if not same(got, ref.topk_decode_reduce_ref(idx, val, sc,
                                                            mask, B)):
                    fail(f"topk_decode_reduce ({what}; B {B}, N {N}, nb "
                         f"{nb}, k {k}, {vdt}) differs from the sender-"
                         f"order sum")
                cases += 1
    return cases


def scatter_add_ms(torch, idx, val, sc, mask, B: int, out) -> float:
    """The yardstick beside topk_decode_reduce: out zeroed, then per sender
    in order out.view(nb, B).scatter_add_(1, idx_i, m_i * (val_i * scale_i))
    over chunks of CHUNK coordinates.  Several PyTorch calls, not one, so
    it is no `library_ms`; the port never calls it.  Prints its time."""
    N, nb, _ = idx.shape
    rows, cb = out.view(nb, B), CHUNK // B

    def run():
        out.zero_()
        for i in range(N):
            for b0 in range(0, nb, cb):
                b1 = min(b0 + cb, nb)
                rows[b0:b1].scatter_add_(
                    1, idx[i, b0:b1].to(torch.int64),
                    mask[i] * (val[i, b0:b1].float() * sc[i, b0:b1, None]))
    ms = cuda_ms(run, 3)
    print(f"yardstick, several calls (scatter_add_ per sender and chunk): "
          f"topk_decode_reduce's function at n={nb * B}, B {B}: {ms} ms",
          flush=True)
    return ms


def topk_at_slice(torch, ref, tp, gen, dev, n: int) -> dict:
    """B3, B6 and B4 at the slice's n (past 2**31 elements) in the train
    step's layout: e is a row of a 2-D buffer updated in place, payloads
    go into rows of the (N, n/B, K) and (N, n/B) buffers.  Row 0 of `e`
    keeps the inputs, row 1 is the one the kernel updates.  Straggler and
    live launches of B3 (payload rows 2 and 1) and a live one with a
    rank's budget k_send = 2 (row 0), B6 on g (row 3, then cut to a budget
    of 2) and on e (row 0), then B4 over the four rows; each held against
    its plain version chunk by chunk, bit for bit, then timed.  As a
    yardstick only, torch.topk of |g| per block is timed too: not the same
    function (its tie order differs, ROADMAP C1)."""
    gamma = 5e-3
    g, e = topk_inputs(torch, gen, dev, n, rows=2)
    gamma_t = torch.tensor(gamma, device=dev)
    nb = n // BLOCK
    idx = torch.zeros((N_CODE, nb, K), dtype=torch.uint16, device=dev)
    val = torch.zeros((N_CODE, nb, K), device=dev)
    sc = torch.zeros((N_CODE, nb), device=dev)
    masks = torch.tensor([1.0, 0.0], device=dev)
    cb = CHUNK // BLOCK

    def row(r):
        return idx[r], val[r], sc[r]

    def chunk(r, i, j):
        return idx[r, i // BLOCK:j // BLOCK], val[r, i // BLOCK:j // BLOCK], \
            sc[r, i // BLOCK:j // BLOCK]

    for r, m in ((2, masks[1]), (1, masks[0])):
        tp.ef_topk_fused(g, e[1], gamma_t, m, K, BLOCK, out=row(r) + (e[1],))
        torch.cuda.synchronize()
        what = f"ef_topk_fused at n={n} (mask={m.item()})"
        if m.item() == 0.0 and not same(e[1], e[0]):
            fail(f"{what}: a straggler's e changed")
        for i in range(0, n, CHUNK):
            j = min(i + CHUNK, n)
            want = ref.ef_topk_fused_ref(g[i:j], e[0, i:j], gamma_t, m, K,
                                         BLOCK)
            compare_topk(chunk(r, i, j) + (None, e[1, i:j]), want, what)
            del want
    ks = K_BUDGETS[3]
    e[1].copy_(e[0])
    tp.ef_topk_fused(g, e[1], gamma_t, masks[0], K, BLOCK,
                     out=row(0) + (e[1],), k_send=ks)
    torch.cuda.synchronize()
    for i in range(0, n, CHUNK):
        j = min(i + CHUNK, n)
        want = ref.ef_topk_fused_ref(g[i:j], e[0, i:j], gamma_t, masks[0], K,
                                     BLOCK, k_send=ks)
        compare_topk(chunk(0, i, j) + (None, e[1, i:j]), want,
                     f"ef_topk_fused at n={n} (k_send={ks})")
        del want
    out, more = {}, {}
    more["ef_topk_fused"] = {"ms_k_send_2": cuda_ms(
        lambda: tp.ef_topk_fused(g, e[1], gamma_t, masks[0], K, BLOCK,
                                 out=row(0) + (e[1],), k_send=ks), 10)}
    ms = cuda_ms(lambda: tp.ef_topk_fused(g, e[1], gamma_t, masks[0], K,
                                          BLOCK, out=row(1) + (e[1],)), 10)

    def plain_ef():
        for i in range(0, n, CHUNK):
            ref.ef_topk_fused_ref(g[i:i + CHUNK], e[0, i:i + CHUNK], gamma_t,
                                  masks[0], K, BLOCK)
    out["ef_topk_fused"] = (ms, cuda_ms(plain_ef, 2)) + bill(
        "ef_topk_fused", n, BLOCK, K)

    tp.topk_pack(g, K, BLOCK, out=row(3))
    tp.topk_pack(e[0], K, BLOCK, out=row(0))
    torch.cuda.synchronize()
    for r, x in ((3, g), (0, e[0])):
        for i in range(0, n, CHUNK):
            j = min(i + CHUNK, n)
            compare_topk(chunk(r, i, j), ref.topk_pack_ref(x[i:j], K, BLOCK),
                         f"topk_pack at n={n} (row {r})")
    ms = cuda_ms(lambda: tp.topk_pack(g, K, BLOCK, out=row(3)), 10)

    def plain_pack():
        for i in range(0, n, CHUNK):
            ref.topk_pack_ref(g[i:i + CHUNK], K, BLOCK)
    out["topk_pack"] = (ms, cuda_ms(plain_pack, 2)) + bill(
        "topk_pack", n, BLOCK, K)
    blocks = g.view(-1, BLOCK)
    yard = cuda_ms(lambda: torch.topk(blocks.abs(), K), 10)
    more["topk_pack"] = {"yardstick_torch_topk_ms": yard}
    print(f"yardstick, not the same function (tie order, ROADMAP C1; i64 "
          f"indices, no scale): torch.topk(x.view(-1, {BLOCK}).abs(), {K}) "
          f"at n={n}: {yard} ms", flush=True)

    val[3, :, K_BUDGETS[3]:] = 0                  # a budgeted rank's row
    del e
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
    ghat = torch.empty(n, device=dev)
    tp.topk_decode_reduce(idx, val, sc, mask, BLOCK, out=ghat)
    torch.cuda.synchronize()
    for b0 in range(0, nb, cb):
        b1 = min(b0 + cb, nb)
        want = ref.topk_decode_reduce_ref(idx[:, b0:b1], val[:, b0:b1],
                                          sc[:, b0:b1], mask, BLOCK)
        if not same(ghat[b0 * BLOCK:b1 * BLOCK], want):
            fail(f"topk_decode_reduce at n={n} differs from the sender-order"
                 f" sum in blocks [{b0}, {b1})")
        del want
    ms = cuda_ms(lambda: tp.topk_decode_reduce(idx, val, sc, mask, BLOCK,
                                               out=ghat), 10)

    def plain_decode():
        for b0 in range(0, nb, cb):
            ref.topk_decode_reduce_ref(idx[:, b0:b0 + cb], val[:, b0:b0 + cb],
                                       sc[:, b0:b0 + cb], mask, BLOCK)
    out["topk_decode_reduce"] = (ms, cuda_ms(plain_decode, 2)) + bill(
        "topk_decode_reduce", N_CODE, n, BLOCK, K)
    more["topk_decode_reduce"] = {"yardstick_scatter_add_ms": scatter_add_ms(
        torch, idx, val, sc, mask, BLOCK, ghat)}
    res = {}
    for name, (ms, plain_ms, moved, ops) in out.items():
        b, by = bound(moved, ops)
        res[name] = {"max_ulp": 0, "max_abs_err": 0.0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "ops": ops, "gb_per_s": moved / ms / 1e6}
        if name in more:
            res[name]["more"] = more[name]
    return res


def budgets_at_slice(torch, ref, tp, gen, dev, n: int, B: int, k: int,
                     budgets) -> dict:
    """B3 and B4 at the slice's n on the driver's budgeted block top-K
    wire (blocks of B, k_max = k, the ranks' k_send = `budgets`, or no
    budget when None), in the train step's layout: each rank's local step
    writes its payload row with its own k_send (the last rank also as a
    straggler, mask 0, which must leave e as it was), then B4 decodes the
    four rows with that rank's mask 0.  Each launch is held against its
    plain version chunk by chunk, bit for bit, then timed (B3 at the
    largest and the smallest budget)."""
    gamma = 5e-3
    ks = (None,) * N_CODE if budgets is None else budgets
    g, e = topk_inputs(torch, gen, dev, n, rows=2, B=B, k=k)
    gamma_t = torch.tensor(gamma, device=dev)
    nb = n // B
    idx = torch.zeros((N_CODE, nb, k), dtype=torch.uint16, device=dev)
    val = torch.zeros((N_CODE, nb, k), device=dev)
    sc = torch.zeros((N_CODE, nb), device=dev)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)

    def row(r):
        return idx[r], val[r], sc[r]

    def launch(r, m):
        tp.ef_topk_fused(g, e[1], gamma_t, m, k, B, out=row(r) + (e[1],),
                         k_send=ks[r])

    for r in range(N_CODE):
        for m in ((mask[r],) if r < N_CODE - 1 else (mask[0], mask[r])):
            e[1].copy_(e[0])
            launch(r, m)
            torch.cuda.synchronize()
            what = (f"ef_topk_fused at n={n}, B {B} (k_send={ks[r]}, "
                    f"mask={m.item()})")
            if m.item() == 0.0 and not same(e[1], e[0]):
                fail(f"{what}: a straggler's e changed")
            for i in range(0, n, CHUNK):
                j = min(i + CHUNK, n)
                want = ref.ef_topk_fused_ref(g[i:j], e[0, i:j], gamma_t, m,
                                             k, B, k_send=ks[r])
                compare_topk((idx[r, i // B:j // B], val[r, i // B:j // B],
                              sc[r, i // B:j // B], None, e[1, i:j]),
                             want, what)
                del want
    lo = min(range(N_CODE), key=lambda r: ks[r] or k)
    ms = {r: cuda_ms(lambda: launch(r, mask[0]), 10) for r in {0, lo}}

    def plain_ef():
        for i in range(0, n, CHUNK):
            ref.ef_topk_fused_ref(g[i:i + CHUNK], e[0, i:i + CHUNK], gamma_t,
                                  mask[0], k, B, k_send=ks[0])
    out = {"ef_topk_fused": (ms[0], cuda_ms(plain_ef, 2)) + bill(
        "ef_topk_fused", n, B, k) + (
        {f"ms_k_send_{ks[lo]}": ms[lo]} if lo else {},)}
    del e
    ghat = torch.empty(n, device=dev)
    tp.topk_decode_reduce(idx, val, sc, mask, B, out=ghat)
    torch.cuda.synchronize()
    cb = CHUNK // B
    for b0 in range(0, nb, cb):
        b1 = min(b0 + cb, nb)
        want = ref.topk_decode_reduce_ref(idx[:, b0:b1], val[:, b0:b1],
                                          sc[:, b0:b1], mask, B)
        if not same(ghat[b0 * B:b1 * B], want):
            fail(f"topk_decode_reduce at n={n}, B {B} (budgets {ks}) "
                 f"differs from the sender-order sum in blocks [{b0}, {b1})")
        del want
    ms = cuda_ms(lambda: tp.topk_decode_reduce(idx, val, sc, mask, B,
                                               out=ghat), 10)

    def plain_decode():
        for b0 in range(0, nb, cb):
            ref.topk_decode_reduce_ref(idx[:, b0:b0 + cb], val[:, b0:b0 + cb],
                                       sc[:, b0:b0 + cb], mask, B)
    out["topk_decode_reduce"] = (ms, cuda_ms(plain_decode, 2)) + bill(
        "topk_decode_reduce", N_CODE, n, B, k) + (
        {"yardstick_scatter_add_ms": scatter_add_ms(torch, idx, val, sc,
                                                    mask, B, ghat)},)
    res = {}
    for name, (ms, plain_ms, moved, ops, more) in out.items():
        b, by = bound(moved, ops)
        res[name] = {"max_ulp": 0, "max_abs_err": 0.0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "gb_per_s": moved / ms / 1e6, **more}
    return res


def global_adversarial_(g, e, B: int, k: int) -> None:
    """The chunks of the global top-K wire (one block of B each, acc =
    gamma*g + e), first four: 0 a tie at the k-th largest |acc| between
    two far-apart 256-blocks (k - 1 larger entries before them); 1 all
    zero, +0 and -0.0 mixed; 2 fewer than k nonzeros, a denormal and a
    -0.0 among them; 3 random but for one block of denormals."""
    c = [slice(j * B, (j + 1) * B) for j in range(4)]
    g[c[0]].clamp_(-1.0, 1.0)
    e[c[0]].mul_(1e-3)
    sets = [(256 * 11 + 7 + 1000 * i, 100.0) for i in range(k - 1)]
    sets += [(256 * 5 + 3, 50.0), (B - 256 * 3 - 9, -50.0)]   # the tie
    for p, v in sets:
        g[p], e[p] = v, 0.0
    g[c[1]] = 0.0
    g[c[1]][::2] = -0.0
    e[c[1]] = -0.0
    g[c[2]] = 0.0
    e[c[2]] = 0.0
    few = [2 * B + 4096 + 100_003 * i for i in range(k // 2)]
    for p, v in zip(few, [1e-40, -0.0] + [1.25] * (k // 2 - 2)):
        g[p] = v
    g[c[3]][1 << 20:(1 << 20) + 256] = 3e-41
    e[c[3]][1 << 20:(1 << 20) + 256] = 0.0


def global_at_slice(torch, ref, tp, gen, dev, n: int) -> dict:
    """Global top-K's route (one block of B = n / N per chunk, k =
    ceil(TOPK_K / N)) at the slice's n: ef_topk_fused on the train step's
    buffers (g is consumed: acc is left in it; e' in place in a row of
    `e`, payload rows of (N, N, k) u32 indices, values and (N, N)
    scales), straggler and live, then topk_pack, then the decode of the
    rows; each held against its plain version (the stable sort of whole
    chunks) chunk by chunk, bit for bit, then timed.  The bound is one
    pass: read g and e, write e', 12 B a coordinate."""
    B, k = n // N_CODE, -(-TOPK_K // N_CODE)
    gamma = 5e-3
    g0, e = topk_inputs(torch, gen, dev, n, rows=2)
    global_adversarial_(g0, e[0], B, k)
    gw = torch.empty_like(g0)
    gamma_t = torch.tensor(gamma, device=dev)
    idx = torch.zeros((N_CODE, N_CODE, k), dtype=torch.uint32, device=dev)
    val = torch.zeros((N_CODE, N_CODE, k), device=dev)
    sc = torch.zeros((N_CODE, N_CODE), device=dev)
    masks = torch.tensor([1.0, 0.0], device=dev)

    def row(r):
        return idx[r], val[r], sc[r]

    def check_chunks(r, got_e, x, m, what):
        for j in range(N_CODE):
            cj = slice(j * B, (j + 1) * B)
            if x is None:
                if not same(gw[cj], ref.mul_add(gamma_t, g0[cj], e[0, cj])):
                    fail(f"{what}: chunk {j}: g does not hold acc")
                want = ref.ef_topk_fused_ref(g0[cj], e[0, cj], gamma_t, m,
                                             k, B)
            else:
                want = ref.topk_pack_ref(x[cj], k, B)
            if not torch.equal(idx[r, j].to(torch.int64),
                               want[0][0].to(torch.int64)):
                fail(f"{what}: chunk {j}'s indices differ")
            if not (same(val[r, j], want[1][0]) and same(sc[r, j:j + 1],
                                                         want[2])):
                fail(f"{what}: chunk {j}'s values or scale differ")
            if got_e is not None and not same(got_e[cj], want[4]):
                fail(f"{what}: chunk {j}'s e' differs")
            del want

    per_call = {}
    for r, m in ((2, masks[1]), (1, masks[0])):
        gw.copy_(g0)
        e[1].copy_(e[0])
        before = tp.launches["topk_pack"]
        tp.ef_topk_fused(gw, e[1], gamma_t, m, k, B, out=row(r) + (e[1],))
        torch.cuda.synchronize()
        per_call["ef_topk_fused"] = tp.launches["topk_pack"] - before
        what = f"global ef_topk_fused at n={n} (mask={m.item()})"
        if m.item() == 0.0 and not same(e[1], e[0]):
            fail(f"{what}: a straggler's e changed")
        check_chunks(r, e[1], None, m, what)
    if idx[1, 0, k - 1].item() != 256 * 5 + 3:
        fail("global ef_topk_fused: the tie's first position not kept last")
    ms = cuda_ms(lambda: tp.ef_topk_fused(gw, e[1], gamma_t, masks[0], k, B,
                                          out=row(1) + (e[1],)), 5)

    def plain_ef():
        for j in range(N_CODE):
            cj = slice(j * B, (j + 1) * B)
            ref.ef_topk_fused_ref(g0[cj], e[0, cj], gamma_t, masks[0], k, B)
    plain_ms = cuda_ms(plain_ef, 1)
    tp.topk_pack(e[0], k, B, out=row(0))        # a fourth sender
    check_chunks(0, None, e[0], None, f"global topk_pack at n={n} (e)")
    del gw, e
    before = tp.launches["topk_pack"]
    tp.topk_pack(g0, k, B, out=row(3))
    torch.cuda.synchronize()
    per_call["topk_pack"] = tp.launches["topk_pack"] - before
    check_chunks(3, None, g0, None, f"global topk_pack at n={n}")
    pack_ms = cuda_ms(lambda: tp.topk_pack(g0, k, B, out=row(3)), 5)
    del g0
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
    ghat = torch.empty(n, device=dev)
    tp.topk_decode_reduce(idx, val, sc, mask, B, out=ghat)
    torch.cuda.synchronize()
    for j in range(N_CODE):
        want = ref.topk_decode_reduce_ref(idx[:, j:j + 1], val[:, j:j + 1],
                                          sc[:, j:j + 1], mask, B)
        if not same(ghat[j * B:(j + 1) * B], want):
            fail(f"global topk_decode_reduce at n={n}: chunk {j} differs "
                 f"from the sender-order sum")
        del want
    decode_ms = cuda_ms(lambda: tp.topk_decode_reduce(idx, val, sc, mask, B,
                                                      out=ghat), 5)
    rounds = tp.global_rounds(B, k)
    if per_call != {"ef_topk_fused": rounds, "topk_pack": rounds}:
        fail(f"global route: B6 launches per call {per_call}, want {rounds}")
    bound_ms, by = bound(12 * n, 2 * n)
    return {"block": B, "k": k, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by,
            "b6_launches_per_call": rounds, "topk_pack_ms": pack_ms,
            "decode_ms": decode_ms}


def pack_adversarial_(x, L: int, k: int) -> None:
    """Blocks of length L at the start of x: +0, -0.0, mixed signed zeros,
    denormals, all |x| equal, k equal maxima of mixed sign before a larger
    entry (ties at the k-th largest), exactly k nonzeros."""
    import torch
    blk = [slice(i * L, (i + 1) * L) for i in range(7)]
    x[blk[0]] = 0.0
    x[blk[1]] = -0.0
    x[blk[2]] = torch.where(x[blk[2]] >= 0, 0.0, -0.0)
    x[blk[3]] = x[blk[3]].sign() * 1e-40
    x[blk[4]] = torch.where(x[blk[4]] >= 0, 1.0, -1.0)
    tie = x[blk[5]]
    tie.mul_(1e-3 / tie.abs().max())
    tie[1:1 + 3 * k:3] = 3.0
    tie[2:2 + 6 * (k // 2):6] = -3.0
    tie[1 + 3 * k] = 5.0
    x[blk[6]] = 0.0
    x[blk[6]][3:3 + 3 * k:3] = 1.5


def pack_inputs(torch, gen, dev, n: int, L: int, k: int):
    """(n,) f32 of widely varying scale per block of L, with the
    adversarial blocks at the start and at the end."""
    x = torch.randn(n, device=dev, generator=gen)
    x.mul_(torch.exp(torch.rand(n // L, device=dev, generator=gen) * 40 - 20)
           .repeat_interleave(L))
    for a in (0, n - 7 * L):
        pack_adversarial_(x[a:a + 7 * L], L, k)
    return x


def check_pack(torch, ref, sp, tp, gen, dev) -> None:
    """B5 and B7 against their plain versions at n = 2**28 on fresh
    buffers, bit for bit: sign_pack at g = GROUP; block_topk in f32 and
    bf16, B in {128, 256, 512}, k in {K, 32}."""
    x = pack_inputs(torch, gen, dev, CHECK_N, GROUP, K)
    words, scales = sp.sign_pack(x, GROUP)
    torch.cuda.synchronize()
    w0, s0 = ref.sign_pack_ref(x, GROUP)
    if not (torch.equal(words, w0) and same(scales, s0)):
        fail(f"sign_pack at n={CHECK_N} differs from the plain version")
    del x, words, scales, w0, s0
    for B in TOPK_BLOCKS:
        for k in (K, 32):
            x = pack_inputs(torch, gen, dev, CHECK_N, B, k)
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                got = tp.block_topk(xd, k, B)
                torch.cuda.synchronize()
                if not same(got, ref.block_topk_ref(xd, k, B)):
                    fail(f"block_topk at n={CHECK_N} (B={B}, k={k}, {dt}) "
                         f"differs from the plain version")
                del xd, got
            del x


def pack_at_slice(torch, ref, sp, tp, gen, dev, n: int) -> dict:
    """B5 and B7 at the slice's n (past 2**31 elements).  sign_pack reads a
    gradient-sized buffer and writes row 1 of the (N, n/32) and (N, n/g)
    payload buffers, as the coco step does; block_topk (k = K, B = BLOCK,
    f32) writes a second (n,) buffer.  Each held against its plain version
    chunk by chunk, bit for bit, then timed."""
    x = pack_inputs(torch, gen, dev, n, BLOCK, K)
    words = torch.zeros((N_CODE, n // 32), dtype=torch.uint32, device=dev)
    scales = torch.zeros((N_CODE, n // GROUP), device=dev)
    sp.sign_pack(x, GROUP, out=(words[1], scales[1]))
    torch.cuda.synchronize()
    for i in range(0, n, CHUNK):
        j = min(i + CHUNK, n)
        w0, s0 = ref.sign_pack_ref(x[i:j], GROUP)
        if not (torch.equal(words[1, i // 32:j // 32], w0)
                and same(scales[1, i // GROUP:j // GROUP], s0)):
            fail(f"sign_pack at n={n} differs from the plain version in "
                 f"[{i}, {j})")
        del w0, s0
    out = {}
    ms = cuda_ms(lambda: sp.sign_pack(x, GROUP, out=(words[1], scales[1])),
                 10)

    def plain_sign():
        for i in range(0, n, CHUNK):
            ref.sign_pack_ref(x[i:i + CHUNK], GROUP)
    out["sign_pack"] = (ms, cuda_ms(plain_sign, 2)) + bill(
        "sign_pack", n, GROUP)
    del words, scales

    y = torch.empty(n, device=dev)
    tp.block_topk(x, K, BLOCK, out=y)
    torch.cuda.synchronize()
    for i in range(0, n, CHUNK):
        j = min(i + CHUNK, n)
        if not same(y[i:j], ref.block_topk_ref(x[i:j], K, BLOCK)):
            fail(f"block_topk at n={n} differs from the plain version in "
                 f"[{i}, {j})")
    ms = cuda_ms(lambda: tp.block_topk(x, K, BLOCK, out=y), 10)

    def plain_topk():
        for i in range(0, n, CHUNK):
            ref.block_topk_ref(x[i:i + CHUNK], K, BLOCK)
    out["block_topk"] = (ms, cuda_ms(plain_topk, 2)) + bill(
        "block_topk", n, K)
    res = {}
    for name, (ms, plain_ms, moved, ops) in out.items():
        b, by = bound(moved, ops)
        res[name] = {"max_ulp": 0, "max_abs_err": 0.0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "ops": ops, "gb_per_s": moved / ms / 1e6}
    return res


def attention_inputs(torch, gen, dev, B, Hkv, groups, S, hd, dtype,
                     q_scale=1.0):
    """q pre-scaled by hd**-0.5 * q_scale, k, v normal; the keys of the
    last quarter of the positions 8 times larger, so the largest raw score
    of most earlier rows sits at a masked position (q_scale = 100 drives
    the scores far past a softcap of 50)."""
    q = torch.randn((B, Hkv * groups, S, hd), device=dev, generator=gen)
    q.mul_(hd ** -0.5 * q_scale)
    k = torch.randn((B, Hkv, S, hd), device=dev, generator=gen)
    v = torch.randn((B, Hkv, S, hd), device=dev, generator=gen)
    k[:, :, S - S // 4:] *= 8.0
    return q.to(dtype), k.to(dtype), v.to(dtype)


def compare_flash(torch, fa, got, want, what: str) -> dict:
    """Within `flash_attention.allowed_error` everywhere (a tolerance in
    value, not in ulps: outputs near 0 may change sign); returns the
    largest absolute error."""
    err = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"{what}: non-finite output")
    if not bool((err <= fa.allowed_error(got, want)).all()):
        fail(f"{what}: off by {err.max().item():.3e}, beyond the stated "
             f"tolerance")
    return {"max_abs_err": err.max().item()}


def flash_case(torch, ref, fa, q, k, v, softcap, window, groups,
               what: str) -> dict:
    """One launch against the plain version (`compare_flash`)."""
    got = fa.flash_attention(q, k, v, softcap=softcap, window=window,
                             groups=groups)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, softcap, window, groups)
    return compare_flash(torch, fa, got, want, what)


def check_flash(torch, ref, fa, gen, dev) -> dict:
    """The adversarial sweep (B 2, Hkv 2) against the plain version, each
    case on its dtype's route (bf16: tensor cores, f32: CUDA cores), then
    the served archs' head widths and group ratios (FLASH_EXTRA)."""
    from repro_torch.kernels.common import flash_routes
    worst = {"max_abs_err": 0.0}
    cases = 0
    routes0 = dict(flash_routes)
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1, 1000, 4096):
            for hd in (16, 64, 288):
                for groups in (1, 2, 4):
                    for softcap, q_scale in ((0.0, 1.0), (50.0, 1.0),
                                             (50.0, 100.0)):
                        q, k, v = attention_inputs(torch, gen, dev, 2, 2,
                                                   groups, S, hd, dtype,
                                                   q_scale)
                        for window in (0, 1, 64, S):
                            worst = merge(worst, flash_case(
                                torch, ref, fa, q, k, v, softcap, window,
                                groups, f"flash_attention ({dtype}, S={S}, "
                                f"hd={hd}, groups={groups}, softcap="
                                f"{softcap}, q_scale={q_scale}, window="
                                f"{window})"))
                            cases += 1
        for S in (1, 1000, 4096):      # the served archs' widths and groups
            for hd, groups in FLASH_EXTRA:
                for softcap, q_scale in ((0.0, 1.0), (50.0, 100.0)):
                    q, k, v = attention_inputs(torch, gen, dev, 2, 2, groups,
                                               S, hd, dtype, q_scale)
                    for window in (0, 64):
                        worst = merge(worst, flash_case(
                            torch, ref, fa, q, k, v, softcap, window,
                            groups, f"flash_attention ({dtype}, S={S}, "
                            f"hd={hd}, groups={groups}, softcap={softcap}, "
                            f"q_scale={q_scale}, window={window})"))
                        cases += 1
    routes = {k: flash_routes[k] - routes0[k] for k in flash_routes}
    if routes != {"tensor_core": cases // 2, "cuda_core": cases // 2}:
        fail(f"flash_attention sweep: routes {routes}, want half of the "
             f"{cases} cases on each")
    worst["cases"] = cases
    worst["routes"] = routes
    return worst


def library_attention(torch, q, k, v, softcap: float, window: int,
                      groups: int, kernel_options=None):
    """One PyTorch call computing B8's function, for `library_ms` only
    (the port never calls it): flex_attention with the tanh softcap as its
    score_mod and the causal (and window) mask as a block mask, so masked
    tiles are skipped; q is pre-scaled (scale 1), enable_gqa maps q head h
    to kv head h // groups.  Every row keeps its diagonal, so masking with
    -inf gives the output JAX's -1e30 gives.  Returns a callable."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    S = q.shape[2]
    w = window if window > 0 else S

    def mask_mod(b, h, i, j):
        return (j <= i) & (i - j < w)

    def score_mod(s, b, h, i, j):
        return softcap * torch.tanh(s / softcap) if softcap > 0 else s

    block_mask = create_block_mask(mask_mod, None, None, S, S,
                                   device=q.device)
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(q, k, v, score_mod=score_mod, block_mask=block_mask,
                      scale=1.0, enable_gqa=groups > 1,
                      kernel_options=kernel_options)


def flash_at_slice(torch, ref, fa, gen, dev, cfg, B=SERVE_BATCH, H=None,
                   Hkv=None) -> dict:
    """B8 at the serve slice's two layer shapes (gemma2-2b: B 32, H 8,
    Hkv 4, S 8192, hd 288, bf16, softcap 50; or one device's heads of the
    shard phase: B, H, Hkv given): a global layer (window 0) and a local
    one (window 4096), each against the plain version, then timed, and
    the library call (`library_attention`) timed on the same inputs.
    The bound counts 4 * hd flops per unmasked (q, k) pair over the bf16
    tensor-core rate, against q, k, v and o each moved once."""
    S, hd, cap = SERVE_SEQ, cfg.head_dim, cfg.attn_softcap
    H, Hkv = H or cfg.num_heads, Hkv or cfg.num_kv_heads
    from repro_torch.kernels.common import flash_routes
    q, k, v = attention_inputs(torch, gen, dev, B, Hkv, H // Hkv, S, hd,
                               torch.bfloat16)
    res, worst = {}, {"max_abs_err": 0.0}
    tensor_core = flash_routes["tensor_core"]
    for window in (0, cfg.sliding_window):
        def kernel(window=window):
            return fa.flash_attention(q, k, v, softcap=cap, window=window,
                                      groups=H // Hkv)

        def plain(window=window):
            return ref.flash_attention_ref(q, k, v, cap, window, H // Hkv)
        library = library_attention(torch, q, k, v, cap, window, H // Hkv,
                                    kernel_options=FLEX_OPTIONS)
        want, plain_ms = timed_once(plain)
        got = kernel()
        torch.cuda.synchronize()
        worst = merge(worst, compare_flash(
            torch, fa, got, want,
            f"flash_attention at the serve slice (window {window})"))
        del got
        lib_err = (library().float() - want.float()).abs().max().item()
        if not lib_err <= LIBRARY_MAX_ABS_ERR:
            fail(f"the library attention (window {window}) is off the "
                 f"plain version by {lib_err:.3e}")
        del want
        moved, flops = bill("flash_attention", B, H, Hkv, S, hd, window, 2)
        t_ops = flops / BF16_OPS_PER_S * 1e3
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(kernel, 5)
        res[window] = {"ms": ms, "plain_ms": plain_ms,
                       "library_ms": cuda_ms(library, 5),
                       "library_max_abs_err": lib_err,
                       "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes
                       else "bytes", "gb_per_s": moved / ms / 1e6,
                       "flops": flops, "tflop_per_s": flops / ms / 1e9,
                       "bound_share": max(t_ops, t_bytes) / ms}
    # every launch above: 1 checked + 1 warm-up + 5 timed per window
    if flash_routes["tensor_core"] - tensor_core != 14:
        fail("flash_attention at the serve slice did not run on the "
             "tensor-core route")
    # the row: the global layer; the local layer's numbers beside it
    glob = dict(res[0])
    more = {k: glob.pop(k)
            for k in ("flops", "tflop_per_s", "library_max_abs_err",
                      "bound_share")}
    return {**worst, **glob, "more": {
        **more,
        **{f"{k}_local": v for k, v in res[cfg.sliding_window].items()}}}


def init_state(torch, setup):
    """`setup.init_state()`: JAX's theta0 and zero error vectors.  An f32
    theta0 is drawn on the card by the first setup of its config, flat
    size and seed (12.4 s at gemma2-2b's full depth) and kept on the host;
    later such setups copy it back a CHUNK at a time (the same bits, about
    2 s), and make e as `init_state` does.  bf16 theta draws every time.
    `main` drops the copies before the serve phases."""
    m = setup.model
    key = (m.cfg, setup.flat_pad, setup.run.seed)
    if m.theta.dtype != torch.float32:
        return setup.init_state()
    if key not in THETA0_HOST:
        e = setup.init_state()
        host = torch.empty(m.theta.numel(), dtype=torch.float32)
        for i in range(0, host.numel(), CHUNK):
            host[i:i + CHUNK].copy_(m.theta[i:i + CHUNK])
        THETA0_HOST[key] = host
        return e
    host = THETA0_HOST[key]
    for i in range(0, host.numel(), CHUNK):
        m.theta[i:i + CHUNK].copy_(host[i:i + CHUNK])
    if setup.cocoef_cfg.mode != "cocoef":
        return None
    return torch.zeros((setup.n_code, setup.flat_pad),
                       dtype=getattr(torch, setup.run.ef_dtype),
                       device=m.theta.device)


def e_checksums(torch, e) -> list:
    """Chunked int64 sums of e's bits (no copy of e fits beside a train
    setup): equal lists before and after a coco path mean e was left
    alone."""
    return [int(bits(r[i:i + CHUNK]).sum(dtype=torch.int64))
            for r in e for i in range(0, r.numel(), CHUNK)]


def train_path(torch, setup, e, first: int, steps: int, label: str,
               want: dict, launches: dict, stats: dict = None) -> dict:
    """`steps` train steps from step `first`, with the launch counts reset
    just before and read just after; fails unless they equal `want`.
    `stats`, when given, gets each step's kernel ms and seconds."""
    batches = [setup.make_batch(t) for t in range(first, first + steps)]
    torch.cuda.synchronize()
    for k in launches:
        launches[k] = 0
    for t, batch in enumerate(batches, first):
        spans = []
        before = dict(launches)
        t_start = time.perf_counter()
        m = setup.train_step(setup.model, e, batch, t, kernel_spans=spans)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t_start
        kernel_ms = sum(a.elapsed_time(b) for a, b in spans)
        if stats is not None:
            stats.setdefault("kernel_ms", []).append(kernel_ms)
            stats.setdefault("step_s", []).append(step_s)
        print(json.dumps({"path": label, "step": t, "loss": loss,
                          "step_s": step_s, "kernel_ms": kernel_ms,
                          "mask": m["mask"].tolist(),
                          "launches": {k: v - before[k]
                                       for k, v in launches.items()
                                       if v != before[k]}}), flush=True)
        if not math.isfinite(loss):
            fail(f"{label} step {t}: loss {loss}")
    got = dict(launches)
    if any(got[k] != want.get(k, 0) for k in got):
        fail(f"{label}: launch counts {got}, want {want}")
    for name, rows in (("theta", [setup.model.theta]),
                       ("e", [] if e is None else list(e))):
        if not all_finite(torch, rows):
            fail(f"{label}: non-finite {name} after training")
    return got


PEAKS = {}                # peak bytes allocated by train path
SIGN_PATHS = ("sign", "sign b2 pipelined", "sign b2 serial",
              "sign phase2 bf16", "sign phase2 sign", "driver markov elastic",
              "driver resume straight", "driver resume save",
              "driver resume restored", "driver prefetch 2 layers",
              "driver sync 2 layers", "driver all flags",
              "driver metrics off", "driver olmoe", "driver deepseek",
              "zamba2 sign", "elastic restart")


def setup_paths(wire: str, rounds: int) -> tuple:
    """(compressor and mode of the setup, its paths): each path is (label,
    mode, k budgets, wire dtype, steps, launches wanted per step).
    `rounds`: the B6 launches of one global top-K selection."""
    if wire == "sign":
        return ("sign", "cocoef"), [
            ("sign", "cocoef", None, "float32", STEPS,
             {"ef_sign_fused": N_CODE, "sign_decode_reduce": 1}),
            ("sign coco", "coco", None, "float32", STEPS,
             {"sign_pack": N_CODE, "sign_decode_reduce": 1})]
    if wire == "block_topk":
        return ("block_topk", "cocoef"), [
            ("block_topk", "cocoef", None, "float32", STEPS,
             {"ef_topk_fused": N_CODE, "topk_decode_reduce": 1}),
            ("block_topk budgets", "cocoef", K_BUDGETS, "float32",
             BUDGET_STEPS, {"ef_topk_fused": N_CODE,
                            "topk_decode_reduce": 1}),
            ("block_topk coco", "coco", None, "float32", STEPS,
             {"topk_pack": N_CODE, "topk_decode_reduce": 1}),
            ("block_topk coco budgets", "coco", K_BUDGETS, "float32",
             BUDGET_STEPS, {"topk_pack": N_CODE, "topk_decode_reduce": 1})]
    if wire == "identity":        # no kernel: JAX has none for the wire
        return ("identity", "cocoef"), [
            ("identity", "cocoef", None, "float32", NEW_STEPS, {}),
            ("identity bf16", "cocoef", None, "bfloat16", NEW_STEPS, {}),
            ("identity coco", "coco", None, "float32", NEW_STEPS, {})]
    if wire == "topk":            # B6's rounds; the union decode is plain
        return ("topk", "cocoef"), [
            ("topk", "cocoef", None, "float32", NEW_STEPS,
             {"topk_pack": N_CODE * rounds}),
            ("topk coco", "coco", None, "float32", NEW_STEPS,
             {"topk_pack": N_CODE * rounds})]
    return ("sign", "dense"), [
        ("dense", "dense", None, "float32", NEW_STEPS, {})]


def train_wire(torch, spec, shape, wire: str, n: int, dev, launches,
               smoke: bool = False, rounds: int = 0, knobs=None,
               paths=None, after=None) -> dict:
    """Every path of one setup in turn on the same model, error and
    payload buffers (`setup_paths`; the block top-K payload is shaped by
    max k = K either way, the dense wire's is the ghat accumulator).  A
    coco path shares the COCO-EF path's error vectors and must leave their
    bits alone; the dense setup allocates none.  Returns the launch counts
    of each path by label; prints each path's peak memory.  `knobs`:
    more TrainRun fields (the dtypes phase's param_dtype and ef_dtype);
    `paths`: (compressor and mode, paths) in place of `setup_paths`';
    `after(setup, e, step)`, when given, runs after the last path on the
    same setup (the dryrun phase's count hold)."""
    from repro_torch.launch.train import TrainRun, build_train_setup
    torch.cuda.reset_peak_memory_stats()
    (compressor, mode), paths = paths or setup_paths(wire, rounds)
    base = TrainRun(base_lr=5e-3, compressor=compressor, mode=mode,
                    **(knobs or {}))
    setup = build_train_setup(spec, shape, base, smoke=smoke, n_code=N_CODE,
                              device=dev)
    if setup.flat_pad != n:
        fail(f"{wire}: flat size {setup.flat_pad} != {n}")
    e = init_state(torch, setup)
    if (e is None) != (mode != "cocoef"):
        fail(f"{wire}: error vectors {'not ' if e is None else ''}allocated "
             f"in {mode} mode")
    counts, first = {}, 0
    for label, mode, kb, wd, steps, per_step in paths:
        run = dataclasses.replace(base, mode=mode, k_budgets=kb)
        plan = dataclasses.replace(spec.coding, wire_dtype=wd)
        path = dataclasses.replace(
            setup, run=run, cocoef_cfg=run.coding_config(plan, N_CODE))
        sums = e_checksums(torch, e) if mode == "coco" else None
        counts[label] = train_path(
            torch, path, e, first, steps, label,
            {k: v * steps for k, v in per_step.items()}, launches)
        # the peak over the path's steps (the first path's includes
        # building the setup)
        peak = torch.cuda.max_memory_allocated()
        PEAKS[label] = peak
        if sums is not None and e_checksums(torch, e) != sums:
            fail(f"{label}: the error vectors changed in coco mode")
        print(f"train ({label}): gemma2-2b "
              f"{setup.model.cfg.num_layers} layers, theta "
              f"{setup.model.theta.dtype}, e "
              f"{None if e is None else e.dtype}, flat {n}, peak "
              f"memory {peak} B ({peak / 1e9:.2f} GB) of "
              f"{torch.cuda.get_device_properties(0).total_memory} B",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        first += steps
    if after is not None:
        after(setup, e, first)
    return counts


def parity_phase(torch, launches) -> dict:
    """The parity gate on the card (`launch/parity.py`): at each of
    PARITY_SIZES, for each wire, the reference loop on the card must equal
    the same loop on the CPU bit for bit, and `run_parity` (the loop
    against the one-device step) must be bit-exact for buckets {1, 2} x
    both schedules, with exactly the step's kernel launches (the loop
    launches none: its compressor is the wire's plain roundtrip)."""
    from repro_torch.launch.parity import (PARITY_COMPRESSORS,
                                           reference_loop, run_parity)
    kernel = {"sign": ("ef_sign_fused", "sign_decode_reduce"),
              "block_topk": ("ef_topk_fused", "topk_decode_reduce")}
    out = {}
    for dim, knobs in PARITY_SIZES:
        for comp in PARITY_COMPRESSORS:
            t0 = time.perf_counter()
            on_card, on_cpu = (reference_loop(comp, PARITY_T, dim=dim,
                                              device=d, **knobs)
                               for d in ("cuda", "cpu"))
            for a, b in zip(on_card, on_cpu):
                if not same(a.cpu(), b):
                    fail(f"parity: the reference loop ({comp}, dim {dim}) "
                         f"on the card differs from the CPU")
            loop_s = time.perf_counter() - t0
            for buckets in (1, BUCKETS):
                for sched in ("serial", "pipelined"):
                    torch.cuda.synchronize()
                    for k in launches:
                        launches[k] = 0
                    t0 = time.perf_counter()
                    r = run_parity(comp, T=PARITY_T, dim=dim,
                                   num_buckets=buckets,
                                   bucket_schedule=sched, device="cuda",
                                   **knobs)
                    torch.cuda.synchronize()
                    got = {k: v for k, v in launches.items() if v}
                    steps = PARITY_T * r["shards"]
                    want = ({} if comp not in kernel else
                            {kernel[comp][0]: steps * r["N"] * buckets,
                             kernel[comp][1]: steps * buckets})
                    if not (r["bitexact"] and math.isfinite(r["loss_ref"])
                            and r["loss_ref"] < r["loss_start"]):
                        fail(f"parity: {json.dumps(r)}")
                    if got != want:
                        fail(f"parity ({comp}, dim {dim}, {buckets} "
                             f"buckets, {sched}): launches {got}, want "
                             f"{want}")
                    out[f"{dim}/{comp}/{buckets}/{sched}"] = {
                        "bitexact": True, "launches": got,
                        "loss_ref": r["loss_ref"], "loss_step": r["loss_step"],
                        "s": time.perf_counter() - t0}
            out[f"{dim}/{comp}/loop card == cpu"] = {"T": PARITY_T,
                                                     "s": loop_s}
    print("parity: " + json.dumps(out), flush=True)
    return out


def bits_hash(torch, rows) -> list:
    """Position-weighted int64 sums of the bits of each HASH_CHUNK of each
    row: equal lists mean equal bits (short of a collision), at a fraction
    of a copy's memory."""
    out = []
    for r in rows:
        for i in range(0, r.numel(), HASH_CHUNK):
            b = r[i:i + HASH_CHUNK].view(torch.int32).to(torch.int64)
            w = torch.arange(1, b.numel() + 1, dtype=torch.int64,
                             device=b.device)
            out.append(int((b * w).sum()))
    return out


def injected_stage2(torch, setup, e, schedule: str) -> tuple:
    """Stage 2 of `setup` on seeded gradients and errors (the same for
    every call), in `schedule`: (hashes of ghat and e, kernel ms)."""
    cfg = dataclasses.replace(setup.cocoef_cfg, bucket_schedule=schedule)
    path = dataclasses.replace(setup, cocoef_cfg=cfg)
    gen = torch.Generator(device=setup.device)
    gen.manual_seed(1)
    for row in e:
        for i in range(0, row.numel(), CHUNK):
            row[i:i + CHUNK].normal_(generator=gen).mul_(0.01)

    def grad_of(i):
        gen.manual_seed(100 + i)
        gbuf = setup.model.grad
        for j in range(0, gbuf.numel(), CHUNK):
            gbuf[j:j + CHUNK].normal_(generator=gen)
        return gbuf
    spans = []
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=setup.device)
    ghat = path.coded_update(path.model, grad_of, e, mask, 1,
                             kernel_spans=spans)
    torch.cuda.synchronize()
    return (bits_hash(torch, [ghat]), bits_hash(torch, e),
            sum(a.elapsed_time(b) for a, b in spans))


def bucket_setups() -> list:
    """(setup knobs, paths) of the buckets phase; a path is (label, run
    knobs, steps, launches per step)."""
    n2 = {"ef_sign_fused": N_CODE * BUCKETS, "sign_decode_reduce": BUCKETS}
    one = {"ef_sign_fused": N_CODE, "sign_decode_reduce": 1}
    return [
        ({"compressor": "sign", "num_buckets": BUCKETS}, [
            ("sign b2 pipelined", {}, 3, n2),
            ("sign b2 serial", {"bucket_schedule": "serial"}, 2, n2)]),
        ({"compressor": "block_topk", "num_buckets": BUCKETS}, [
            ("block_topk b2 pipelined", {}, 2,
             {"ef_topk_fused": N_CODE * BUCKETS,
              "topk_decode_reduce": BUCKETS})]),
        ({"compressor": "sign"}, [
            ("sign phase2 bf16", {"phase2_dtype": "bfloat16"}, 2, one),
            ("sign phase2 sign", {"phase2_sign": True}, 2,
             {**one, "sign_pack": 1})])]


def buckets_phase(torch, spec, shape, dev, launches) -> dict:
    """gemma2-2b at full width and depth, N = 4 on the card, with buckets
    and phase 2 (`bucket_setups`): each setup freed before the next; on
    the bucketed sign setup, stage 2 on the same seeded inputs in both
    schedules must give the same ghat and e bits; then real steps of each
    path with exact launch counts, a peak no higher than its wire's
    unbucketed path in phase 6 (but for the wider padding), and the
    stage-2 kernel ms per step."""
    from repro_torch.core.cocoef import padded_size
    from repro_torch.launch.train import TrainRun, build_train_setup
    from repro_torch.nn.transformer import num_params
    counts, summary = {}, {}
    first = 100
    for knobs, paths in bucket_setups():
        if settle(torch, f"the paths before {paths[0][0]}") > 1 << 30:
            fail("over 1 GiB still allocated before a buckets setup")
        torch.cuda.reset_peak_memory_stats()
        base = TrainRun(base_lr=5e-3, **knobs)
        setup = build_train_setup(spec, shape, base, n_code=N_CODE,
                                  device=dev)
        cfg = setup.cocoef_cfg
        want_n = padded_size(num_params(spec.config), N_CODE,
                             cfg.pad_multiple, cfg.num_buckets)
        if setup.flat_pad != want_n:
            fail(f"buckets: flat size {setup.flat_pad} != {want_n}")
        e = init_state(torch, setup)
        if knobs.get("num_buckets", 1) > 1 and knobs["compressor"] == "sign":
            hp, hs = (injected_stage2(torch, setup, e, sched)
                      for sched in ("pipelined", "serial"))
            if hp[:2] != hs[:2]:
                fail("buckets: the serial schedule's ghat or e differs "
                     "from the pipelined one on the same inputs")
            summary["sign b2 injected"] = {
                "ghat_e_bit_equal": True, "kernel_ms_pipelined": hp[2],
                "kernel_ms_serial": hs[2]}
            summary["sign b2 injected"]["peak_B"] = \
                torch.cuda.max_memory_allocated()
            e = None                      # no second set of e fits
            e = init_state(torch, setup)
            torch.cuda.reset_peak_memory_stats()
        for label, run_knobs, steps, per_step in paths:
            run = dataclasses.replace(base, **run_knobs)
            path = dataclasses.replace(setup, run=run,
                                       cocoef_cfg=run.coding_config(
                                           spec.coding, N_CODE))
            stats = {}
            counts[label] = train_path(
                torch, path, e, first, steps, label,
                {k: v * steps for k, v in per_step.items()}, launches,
                stats)
            peak = torch.cuda.max_memory_allocated()
            PEAKS[label] = peak
            # no higher than the same wire's unbucketed path (phase 6),
            # but for a flat size padded for two buckets: up to
            # pad_multiple * N more coordinates in theta, the gradient and
            # each error row
            one = knobs["compressor"]
            slack = (setup.flat_pad - padded_size(
                num_params(spec.config), N_CODE, cfg.pad_multiple)) * 4 * (
                    2 + N_CODE) + (2 << 20)
            if peak > PEAKS[one] + slack:
                fail(f"buckets ({label}): peak {peak} B over the {one} "
                     f"path's {PEAKS[one]} B (+ {slack} B)")
            summary[label] = {"flat": setup.flat_pad,
                              "kernel_ms": stats["kernel_ms"],
                              "step_s": stats["step_s"], "peak_B": peak,
                              f"{one}_peak_B": PEAKS[one],
                              "launches": {k: v for k, v in
                                           counts[label].items() if v}}
            torch.cuda.reset_peak_memory_stats()
            first += steps
        del setup, path, e
    print("buckets: " + json.dumps(summary), flush=True)
    return counts


def nccl_phase(torch, dev, launches) -> dict:
    """One `nccl` process group of world size 1 (a file:// init under
    build/, no network): the group update (`group_cocoef_update`) on CUDA
    tensors, sign and block top-K, 2 buckets pipelined, must equal the
    one-device update bit for bit, with exact launch counts.  It shows the
    payload's byte views and the async handles work under NCCL; N = 4 over
    NCCL needs four cards (NCCL puts one rank on a card)."""
    import torch.distributed as dist
    from repro_torch.core.cocoef import (CocoEFConfig, cocoef_update,
                                         group_buffers, group_cocoef_update)
    from repro_torch.launch.mesh import coding_grid
    from repro_torch.launch.train import _payload_buffers
    init = ROOT / "build" / f"nccl_init_{os.getpid()}"
    init.parent.mkdir(parents=True, exist_ok=True)
    if init.exists():
        init.unlink()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    out = {}
    try:
        grid = coding_grid((1,))
        gen = torch.Generator(device=dev).manual_seed(7)
        mask = torch.ones(1, device=dev)
        for comp, kern in (("sign", ("ef_sign_fused", "sign_decode_reduce")),
                           ("block_topk", ("ef_topk_fused",
                                           "topk_decode_reduce"))):
            cfg = CocoEFConfig(group_size=GROUP, compressor=comp,
                               block_size=BLOCK, k_per_block=K,
                               num_buckets=BUCKETS)
            g = torch.randn(NCCL_N, generator=gen, device=dev)
            e0 = torch.randn(NCCL_N, generator=gen, device=dev) * 0.01
            e1 = e0.clone()[None]
            want = cocoef_update(lambda i: g.clone(), e1, mask, 5e-3, cfg,
                                 _payload_buffers(cfg, 1, NCCL_N, dev))
            bufs = group_buffers(cfg, grid.nd, NCCL_N, dev)
            e2 = e0.clone()
            torch.cuda.synchronize()
            for k in launches:
                launches[k] = 0
            got = group_cocoef_update(g.clone(), e2, mask, 5e-3, cfg, grid,
                                      bufs)
            torch.cuda.synchronize()
            n_l = {k: v for k, v in launches.items() if v}
            if n_l != {kern[0]: BUCKETS, kern[1]: BUCKETS}:
                fail(f"nccl ({comp}): launches {n_l}")
            if not (same(got, want) and same(e2, e1[0])):
                fail(f"nccl ({comp}): the group update over NCCL differs "
                     f"from the one-device update")
            ms = cuda_ms(lambda: group_cocoef_update(
                g.clone(), e0.clone(), mask, 5e-3, cfg, grid, bufs), 3)
            out[comp] = {"n": NCCL_N, "buckets": BUCKETS,
                         "schedule": "pipelined", "bit_equal": True,
                         "launches": n_l, "ms": ms}
    finally:
        dist.destroy_process_group()
        if init.exists():
            init.unlink()
    print("nccl: " + json.dumps(out) + "; world size 1 on this card: N = 4 "
          "over NCCL needs four cards", flush=True)
    return out



def driver_args(ckpt_dir: Path, device: str, *flags,
                arch: str = "gemma2-2b"):
    """Parsed flags of `python -m repro_torch.launch.train_e2e`."""
    from repro_torch.launch import train_e2e
    return train_e2e.build_parser().parse_args(
        ["--device", device, "--arch", arch, "--ckpt-dir", str(ckpt_dir),
         *flags])


def driver_run(torch, launches, label: str, args, spec, shape, want: dict,
               out: dict) -> dict:
    """One `train_e2e.run` on the card, the launch counts reset just before
    and read just after (they must equal `want`), the peak memory reset
    before it; prints each step's record and the peak, and fails on a
    non-finite theta or e.  Returns run's result."""
    from repro_torch.launch import train_e2e
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in launches:
        launches[k] = 0
    res = train_e2e.run(args, spec=spec, shape=shape, smoke=False)
    torch.cuda.synchronize()
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        fail(f"driver ({label}): launch counts {got}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    for r in res["steps"]:
        print(json.dumps({"path": f"driver {label}", **{
            k: r[k] for k in ("step", "loss", "step_s", "kernel_ms",
                              "kernel_spans_ms", "batch_s", "mask")},
            "plane_s": r.get("plane_s"),
            "replan": {k: r["replan"][k] for k in ("epoch", "drift",
                                                   "reallocated")}
            if "replan" in r else None}), flush=True)
        if not math.isfinite(r["loss"]):
            fail(f"driver ({label}) step {r['step']}: loss {r['loss']}")
    setup = res["setup"]
    for name, rows in (("theta", [setup.model.theta]), ("e", list(res["e"]))):
        if not all_finite(torch, rows):
            fail(f"driver ({label}): non-finite {name}")
    PEAKS[f"driver {label}"] = peak
    out[label] = {"launches": got, "peak_bytes": peak,
                  "step_s": [r["step_s"] for r in res["steps"]],
                  "kernel_ms": [r["kernel_ms"] for r in res["steps"]],
                  "batch_s": [r["batch_s"] for r in res["steps"]]}
    print(f"driver ({label}): {setup.model.cfg.name} "
          f"{setup.model.cfg.num_layers} layers, flat {setup.flat_pad}, "
          f"peak memory {peak} B "
          f"({peak / 1e9:.2f} GB) of "
          f"{torch.cuda.get_device_properties(0).total_memory} B", flush=True)
    return res


def driver_phase(torch, spec, dev, launches) -> dict:
    """The training driver (`repro_torch.launch.train_e2e.run`, its own
    coding overrides: group 32, block 64, k 8) on gemma2-2b at full width,
    N = 4 on the card, seq SEQ_LEN, global batch GLOBAL_BATCH, one run's
    tensors freed before the next:
      - markov stragglers (p 0.25) with the elastic coding plane, full
        depth, DRIVER_STEPS steps; the same flags on the CPU (smoke
        config, same shape) must give the same masks, allocations and
        batch weights at every step;
      - block top-K with the budgets solved for uplinks of 10, 10, 5 and
        2.5 Gbit/s, full depth, DRIVER_BUDGET_STEPS steps;
      - crash and resume at RESUME_LAYERS layers (full width): 4 steps
        straight, then 2 steps with a checkpoint, every tensor dropped, a
        restore into a fresh setup and 2 more steps: theta and e must hash
        equal.  The checkpoints go to a temporary directory, removed
        after."""
    import shutil
    import tempfile
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch import train_e2e
    from repro_torch.nn.transformer import num_params
    shape = ShapeCfg("train", SEQ_LEN, GLOBAL_BATCH)

    def sign(steps: int) -> dict:
        return {"ef_sign_fused": N_CODE * steps, "sign_decode_reduce": steps}
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_driver_"))
    try:
        free = shutil.disk_usage(tmp).free
        print(f"driver: checkpoints under {tmp}, {free} B free", flush=True)
        never = ("--ckpt-every", str(1 << 30))
        flags = ("--steps", str(DRIVER_STEPS), "--straggler", "markov",
                 "--straggler-p", "0.25", "--elastic", *never)
        res = driver_run(torch, launches, "markov elastic",
                         driver_args(tmp / "elastic", "cuda", *flags), spec,
                         shape, sign(DRIVER_STEPS), out)
        card = [{k: r[k] for k in ("mask", "allocation", "weights")}
                for r in res["steps"]]
        out["markov elastic"]["replans"] = [
            r["replan"]["epoch"] for r in res["steps"]]
        del res
        settle(torch, "the driver's elastic run")
        cpu = train_e2e.run(driver_args(tmp / "cpu", "cpu", *flags),
                            spec=spec, shape=shape, smoke=True)
        if [{k: r[k] for k in ("mask", "allocation", "weights")}
                for r in cpu["steps"]] != card:
            fail("driver: the card's masks, allocations or batch weights "
                 "differ from the CPU's")
        out["markov elastic"]["card == cpu"] = True

        res = driver_run(torch, launches, "budgets",
                         driver_args(tmp / "budgets", "cuda", "--steps",
                                     str(DRIVER_BUDGET_STEPS),
                                     "--compressor", "block_topk",
                                     "--rank-uplink-gbps", DRIVER_UPLINKS,
                                     *never), spec, shape,
                         {"ef_topk_fused": N_CODE * DRIVER_BUDGET_STEPS,
                          "topk_decode_reduce": DRIVER_BUDGET_STEPS}, out)
        out["budgets"]["k"] = list(res["setup"].cocoef_cfg.k_per_block)
        if tuple(out["budgets"]["k"]) != DRIVER_K_BUDGETS:
            fail(f"driver: budgets {out['budgets']['k']} solved, the kernel "
                 f"checks ran {DRIVER_K_BUDGETS}")
        del res
        settle(torch, "the driver's budgets run")

        all_flags_phase(torch, launches, spec, shape, tmp, out)

        cut = dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, num_layers=RESUME_LAYERS))
        hashes = {}
        for label, d, steps, every, want in (
                ("resume straight", "straight", 4, 1 << 30, sign(4)),
                ("resume save", "crash", 2, 2, sign(2)),
                ("resume restored", "crash", 4, 1 << 30, sign(2))):
            res = driver_run(torch, launches, label,
                             driver_args(tmp / d, "cuda", "--steps",
                                         str(steps), "--ckpt-every",
                                         str(every)), cut, shape, want, out)
            if label != "resume save":
                hashes[label] = (bits_hash(torch, [res["setup"].model.theta]),
                                 bits_hash(torch, res["e"]))
            for c in res["ckpt"]:
                out[label]["ckpt"] = {k: c[k] for k in ("step", "bytes",
                                                        "save_s")}
            if res["restore_s"] is not None:
                out[label]["restore_s"] = res["restore_s"]
                out[label]["start"] = res["start"]
            del res
            if settle(torch, f"the driver's {label} run") > 1 << 30:
                fail("driver: over 1 GiB still allocated between runs")
        pf_hashes = {}
        for label, pf in (("prefetch 2 layers", ("--prefetch", "2")),
                          ("sync 2 layers", ())):
            res = driver_run(torch, launches, label,
                             driver_args(tmp / label.replace(" ", "_"),
                                         "cuda", "--steps", "4",
                                         "--straggler", "markov",
                                         "--straggler-p", "0.25",
                                         "--elastic", *never, *pf),
                             cut, shape, sign(4), out)
            pf_hashes[label] = (bits_hash(torch,
                                          [res["setup"].model.theta]),
                                bits_hash(torch, res["e"]))
            out[label]["prefetch"] = res["prefetch"]
            del res
            settle(torch, f"the driver's {label} run")
        if pf_hashes["prefetch 2 layers"] != pf_hashes["sync 2 layers"]:
            fail("driver: the prefetched run's theta or e differs from the "
                 "synchronous run's")
        out["prefetch 2 layers"]["bit_equal_to_sync"] = True
        if out["resume restored"].get("start") != 2:
            fail("driver: the restored run did not resume from step 2")
        if hashes["resume straight"] != hashes["resume restored"]:
            fail("driver: theta or e after save, restore and 2 steps "
                 "differs from 4 steps straight")
        out["resume restored"]["bit_equal"] = True
        out["params"] = {"full": num_params(spec.config),
                         f"{RESUME_LAYERS} layers": num_params(cut.config)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("driver: " + json.dumps(out), flush=True)
    return {f"driver {k}": v["launches"] for k, v in out.items()
            if isinstance(v, dict) and "launches" in v}


def family_path(key: str) -> str:
    """The path label of phase 10's cell `key` (its launch counts'
    key)."""
    arch, how, _, _, comp = FAMILY_CELLS[key]
    return f"driver {key}" if how == "driver" else f"{key} {comp}"


def families_kernels(torch, ref, sp, tp, gen, dev, wires) -> dict:
    """The kernels of phase 10's paths at their shapes, as its cells called
    them: B1 and B2 at each sign cell's n and group (olmoe and deepseek
    g 32, zamba2 g 512), B3 and B4 at each block top-K cell's n, block
    and k (musicgen, xlstm; no budget), each held against its plain
    version chunk by chunk and timed, as on the driver's wire.  Returns
    {key: (its path, {kernel: numbers})}."""
    out = {}
    for key, w in wires.items():
        if len(w) == 2:
            n, G = w
            held = {"ef_sign_fused": {"n": n, "group": G, **ef_at_slice(
                torch, ref, sp, gen, dev, n, G)}}
            settle(torch, f"ef_sign_fused at {key}'s n, g {G}")
            held["sign_decode_reduce"] = {"n": n, "group": G,
                                          **decode_at_slice(
                                              torch, ref, sp, gen, dev, n,
                                              G)}
            settle(torch, f"sign_decode_reduce at {key}'s n, g {G}")
        else:
            n, B, k = w
            held = {name: {"n": n, "block": B, "k": k, **r} for name, r in
                    budgets_at_slice(torch, ref, tp, gen, dev, n, B, k,
                                     None).items()}
            settle(torch, f"the block top-K kernels at {key}'s n")
        out[key] = (family_path(key), held)
    print(f"kernels vs plain and times on the families' wires, train "
          f"layout: {json.dumps({k: v[1] for k, v in out.items()})}",
          flush=True)
    return out


def families_phase(torch, dev, launches, cells=FAMILY_CELLS) -> tuple:
    """Phase 10 of the module docstring over `cells` (FAMILY_CELLS'
    layout), one setup at a time, each freed before the next; returns the
    launch counts of their paths and their kernels' shapes: {key: (n, g)}
    on the sign wire, {key: (n, B, k)} on block top-K."""
    import shutil
    import tempfile
    from repro_torch.configs import REGISTRY, ShapeCfg
    from repro_torch.launch.train import TrainRun, build_train_setup
    from repro_torch.nn.transformer import num_params
    shape = ShapeCfg("train", SEQ_LEN, GLOBAL_BATCH)
    total = torch.cuda.get_device_properties(0).total_memory
    out, counts, wires = {}, {}, {}
    for key, (arch, how, layers, steps, comp) in cells.items():
        spec = REGISTRY[arch]
        full = spec.config.num_layers
        if layers:
            spec = dataclasses.replace(spec, config=dataclasses.replace(
                spec.config, num_layers=layers))
        sign = comp == "sign"
        want = ({"ef_sign_fused": N_CODE * steps,
                 "sign_decode_reduce": steps} if sign else
                {"ef_topk_fused": N_CODE * steps,
                 "topk_decode_reduce": steps})
        path = family_path(key)
        if how == "driver":
            tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{key}_"))
            try:
                res = driver_run(torch, launches, key, driver_args(
                    tmp, "cuda", "--steps", str(steps), "--ckpt-every",
                    str(1 << 30), arch=arch), spec, shape, want, out)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            setup, cell = res["setup"], out.pop(key)
            cell.update(init_s=res["init_s"])
            if "moe_dropped" in res["steps"][0]:
                cfg = setup.model.cfg
                moe_layers = cfg.num_layers - (cfg.family == "deepseek")
                cell.update(
                    moe_dropped=[r["moe_dropped"] for r in res["steps"]],
                    assignments_per_rank=moe_layers * setup.b_loc
                    * SEQ_LEN * cfg.moe_top_k)
            del res
        else:
            torch.cuda.reset_peak_memory_stats()
            setup = build_train_setup(spec, shape, TrainRun(
                base_lr=5e-3, compressor=comp), smoke=False, n_code=N_CODE,
                device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e = setup.init_state()
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            stats = {}
            got = train_path(torch, setup, e, 0, steps, path, want,
                             launches, stats)
            peak = torch.cuda.max_memory_allocated()
            PEAKS[path] = peak
            cell = {"launches": got, "init_s": init_s, "peak_bytes": peak,
                    **stats}
            del e
            if any(c[5] == key for c in SERVE_CELLS.values()):
                # phase 12 serves this theta: onto the host until then
                HELD_THETA[key] = {k: v.to("cpu") for k, v in
                                   setup.model.params().items()}
        cfg, ccfg = setup.model.cfg, setup.cocoef_cfg
        cell.update({"layers": f"{cfg.num_layers} of {full}",
                     "params": num_params(cfg), "flat": setup.flat_pad,
                     "total_memory": total})
        wires[key] = ((setup.flat_pad, ccfg.group_size) if sign else
                      (setup.flat_pad, ccfg.block_size, ccfg.k_per_block))
        if not sign:
            cell.update(block=ccfg.block_size, k=ccfg.k_per_block)
        out[path] = cell
        counts[path] = cell["launches"]
        del setup
        settle(torch, f"the {key} run")
    print("families: " + json.dumps(out), flush=True)
    return counts, wires


def init_slices(cfg) -> list:
    """(leaf, layer or None, first row, rows) of the full-width theta0
    checked against numpy: all of layer 0's wq, the first and last
    INIT_ROWS rows of the token table, and layer INIT_LAYER's w_down."""
    v = cfg.vocab_size
    return [("blocks/attn/wq", 0, 0, cfg.d_model),
            ("embed/tok", None, 0, INIT_ROWS),
            ("embed/tok", None, v - INIT_ROWS, INIT_ROWS),
            ("blocks/mlp/w_down", INIT_LAYER, 0, cfg.d_ff)]


def init_phase(torch, spec, dev) -> dict:
    """theta0 is JAX's `init_params(PRNGKey(0))` on both devices (C13):
    at the smoke config the card's theta equals the CPU's bit for bit; at
    full width the card draws all 2,660,228,352 values (timed, CUDA
    synchronised) and `init_slices` of them must equal numpy's draws of
    the same counters (`prng.normal_range`, four threads)."""
    import threading
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.nn.models import Model
    from repro_torch.nn.transformer import init_keys
    cpu = Model(spec.smoke, chunk_ranks=N_CODE, group_size=GROUP,
                device="cpu")
    cpu.init_(0)
    card = Model(spec.smoke, chunk_ranks=N_CODE, group_size=GROUP,
                 device=dev)
    card.init_(0)
    if not torch.equal(cpu.theta, card.theta.cpu()):
        fail("init: the card's smoke theta0 differs from the CPU's")
    del cpu, card
    cfg = spec.config
    m = Model(cfg, chunk_ranks=N_CODE, group_size=GROUP, device=dev,
              with_grad=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.init_(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    keys, params = init_keys(cfg, prng.PRNGKey(0)), m.params()
    jobs = [(name, layer, r0, min(INIT_PIECE, row + rows - r0))
            for name, layer, row, rows in init_slices(cfg)
            for r0 in range(row, row + rows, INIT_PIECE)]
    res = {}

    def check(i, name, layer, row, rows):
        key, fan = keys[name]
        v = params[name] if layer is None else params[name][layer]
        width = math.prod(v.shape[1:])
        got = v[row:row + rows].reshape(-1).cpu().numpy()
        want = prng.normal_range(key if layer is None else key[layer],
                                 row * width, rows * width,
                                 prng.init_scale(fan))
        res[i] = (f"{name}[{'' if layer is None else f'{layer}, '}"
                  f"{row}:{row + rows}]", got.size,
                  int((got.view(np.int32) != want.view(np.int32)).sum()))
    t0 = time.perf_counter()
    todo = list(enumerate(jobs))

    def worker():
        while todo:
            try:
                i, job = todo.pop()
            except IndexError:
                return
            check(i, *job)
    threads = [threading.Thread(target=worker)
               for _ in range(os.cpu_count() or 4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    numpy_s = time.perf_counter() - t0
    if len(res) != len(jobs) or any(r[2] for r in res.values()):
        fail(f"init: the card's theta0 differs from numpy's draws: {res}")
    out = {"smoke card == cpu": True, "full_init_s": init_s,
           "draws": m.layout.total, "numpy_s": numpy_s,
           "slices_bit_equal": {f"{n}[{'' if l is None else f'{l}, '}"
                                f"{r}:{r + k}]": k * math.prod(
                                    params[n].shape[1 if l is None else 2:])
                                for n, l, r, k in init_slices(cfg)}}
    del m, params
    print("init: " + json.dumps(out), flush=True)
    return out


def frame_cost(torch, setup, e, reps: int = FRAME_REPS) -> dict:
    """Stage 2 and the update (`coded_update`) on the setup's own buffers,
    timed with and without the telemetry frame, alternating (host clock
    between synchronises, every rank participating): the frame's ms a
    step is the difference of the medians.  Run after the setup's bits
    were hashed: it keeps updating theta and e."""
    mask = torch.ones(N_CODE, dtype=torch.float32, device=e.device)
    grad = setup.model.grad
    times = {"on": [], "off": []}
    for _ in range(reps):
        for key in ("off", "on"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            setup.coded_update(setup.model, lambda i: grad, e, mask, 0,
                               frames=[] if key == "on" else None)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    return {"on_ms": times["on"], "off_ms": times["off"],
            "frame_ms": med["on"] - med["off"]}


def all_flags_phase(torch, launches, spec, shape, tmp: Path, out: dict
                    ) -> None:
    """The driver's last three flags at full width and depth:
    `--plan auto --metrics --prefetch 2` with markov stragglers (p 0.25),
    DRIVER_STEPS steps.  The card must pick the plan the CPU's planner
    picks for the same flags, launch the kernels of that plan's wire
    only, and write JSONL that passes `validate_record` and a trace that
    passes `validate_chrome_trace` (the port's copies).  Then the same
    plan without --metrics: the same theta and e bits and launches, and
    the frame's cost as the difference of the step seconds."""
    from repro_torch.launch import train_e2e
    from repro_torch.obs import read_jsonl, validate_chrome_trace, \
        validate_record
    never = ("--ckpt-every", str(1 << 30))
    flags = ("--steps", str(DRIVER_STEPS), "--straggler", "markov",
             "--straggler-p", "0.25", *never)
    cpu_args = driver_args(tmp / "plan_cpu", "cpu", *flags, "--plan", "auto",
                           "--plan-out", str(tmp / "plan_cpu.json"))
    t0 = time.perf_counter()
    want_plan = train_e2e._auto_plan(
        cpu_args, train_e2e._driver_spec(cpu_args, spec), N_CODE, None,
        cpu_args.plan_out)
    cpu_plan_s = time.perf_counter() - t0
    per_step = {"sign": {"ef_sign_fused": N_CODE, "sign_decode_reduce": 1},
                "block_topk": {"ef_topk_fused": N_CODE,
                               "topk_decode_reduce": 1},
                "identity": {}}
    if want_plan.compressor not in per_step:
        fail(f"driver: the planner picked {want_plan.compressor}, which this "
             f"phase has no launch counts for")
    B = want_plan.num_buckets
    want = {k: v * B * DRIVER_STEPS
            for k, v in per_step[want_plan.compressor].items()}
    plan_out = tmp / "plan.json"
    t0 = time.perf_counter()
    res = driver_run(torch, launches, "all flags",
                     driver_args(tmp / "flags", "cuda", *flags,
                                 "--plan", "auto", "--plan-out",
                                 str(plan_out), "--metrics", "--metrics-dir",
                                 str(tmp / "metrics"), "--prefetch", "2"),
                     spec, shape, want, out)
    run_s = time.perf_counter() - t0
    got_plan = res["setup"].plan
    if got_plan != dataclasses.replace(want_plan, num_ranks=N_CODE):
        fail(f"driver: the card's planner picked {got_plan.to_json()}, the "
             f"CPU's {want_plan.to_json()}")
    recs = read_jsonl(res["metrics"]["jsonl"])
    for r in recs:
        validate_record(r)
    kinds = [r["kind"] for r in recs]
    if kinds != ["run_meta"] + ["train_step"] * DRIVER_STEPS + ["prefetch"]:
        fail(f"driver: metrics records {kinds}")
    validate_chrome_trace(json.loads(Path(res["metrics"]["trace"])
                                     .read_text()))
    steps = [r for r in recs if r["kind"] == "train_step"]
    sync_batch = out["markov elastic"]["batch_s"]
    flags_hash = (bits_hash(torch, [res["setup"].model.theta]),
                  bits_hash(torch, res["e"]))
    frame_ms = frame_cost(torch, res["setup"], res["e"])
    out["all flags"].update({
        "plan": got_plan.to_dict(), "plan_equals_cpu": True,
        "cpu_plan_s": cpu_plan_s, "run_s": run_s,
        "batch_wait_ms": [x * 1e3 for x in res["metrics"]["batch_wait_s"]],
        "sync_batch_ms": [x * 1e3 for x in sync_batch],
        "prefetch": res["prefetch"], "records": len(recs),
        "spans_ms": [{k: v * 1e3 for k, v in r["spans"].items()}
                     for r in steps],
        "predicted_step_ms": [x * 1e3 for x in
                              res["metrics"]["predicted_step_s"]],
        "stage2_ms_frame_on_off": frame_ms,
        "telemetry_last": {k: steps[-1][k] for k in (
            "participation", "wire_bytes_rank", "bytes_down",
            "grad_norm_rank", "compress_cosine_rank", "ghat_norm",
            "update_norm", "param_norm")}})
    del res
    settle(torch, "the driver's all-flags run")
    res = driver_run(torch, launches, "metrics off",
                     driver_args(tmp / "off", "cuda", *flags, "--plan",
                                 str(plan_out), "--prefetch", "2"),
                     spec, shape, want, out)
    if (bits_hash(torch, [res["setup"].model.theta]),
            bits_hash(torch, res["e"])) != flags_hash:
        fail("driver: --metrics changed theta or e")
    out["metrics off"]["bit_equal_to_metrics_on"] = True
    del res
    settle(torch, "the driver's metrics-off run")


def serve_request(torch, setup, prompts, launches, n_attn: int,
                  feeds=None):
    """Prefill `prompts` ((B, S) tokens or (B, S, d) embeddings), then
    NEW_TOKENS decode steps: greedy, or fed `feeds` (NEW_TOKENS, B, 1, d)
    (the embeddings input), with the launch counts reset just before and
    checked after each part: one flash_attention launch per GQA attention
    layer (`n_attn`) in the prefill, each on the tensor-core route, none
    in the decode.  Every cache position leaf must be the ring JAX
    writes (slot pos % S of each step).
    Returns (tokens (B, NEW_TOKENS + 1), logits (NEW_TOKENS + 1, B, V),
    prefill seconds, decode seconds, seconds the host took to enqueue the
    decode steps)."""
    from repro_torch.kernels.common import flash_routes
    from repro_torch.launch.device_parity import cache_leaves
    B, S = prompts.shape[:2]
    torch.cuda.synchronize()
    for counts in (launches, flash_routes):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    logits, caches = setup.prefill_step(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    want = {"flash_attention": n_attn} if n_attn else {}
    if any(launches[k] != want.get(k, 0) for k in launches):
        fail(f"serve prefill: launch counts {dict(launches)}, want {want}")
    if flash_routes != {"tensor_core": n_attn, "cuda_core": 0}:
        fail(f"serve prefill: flash_attention routes {flash_routes}, want "
             f"all {n_attn} on the tensor cores")
    toks, outs = [logits.argmax(-1)], [logits]
    t0 = time.perf_counter()
    for i in range(NEW_TOKENS):
        inp = toks[-1][:, None] if feeds is None else feeds[i]
        logits, caches = setup.decode_step(caches, inp, S + i)
        toks.append(logits.argmax(-1))
        outs.append(logits)
    enqueue_s = time.perf_counter() - t0   # the host never waits in the
    torch.cuda.synchronize()               # loop: near decode_s means the
    decode_s = time.perf_counter() - t0    # card waits for the host
    if any(launches[k] != want.get(k, 0) for k in launches):
        fail(f"serve decode: launch counts {dict(launches)}, want none "
             f"beyond the prefill's {want}")
    outs = torch.stack(outs)
    if outs.shape != (NEW_TOKENS + 1, B, setup.model.cfg.vocab_size):
        fail(f"serve: logits of shape {tuple(outs.shape)}")
    if not bool(torch.isfinite(outs.float()).all()):
        fail("serve: non-finite logits")
    for path, pos in cache_leaves(caches):
        if path.endswith("pos"):
            want_pos = torch.arange(S, device=pos.device, dtype=pos.dtype)
            want_pos[:NEW_TOKENS] += S      # ring slots pos % S of the decode
            if not bool((pos == want_pos).all()):
                fail(f"serve: cache positions {path} are not the ring JAX "
                     f"writes")
    return torch.stack(toks, 1), outs, prefill_s, decode_s, enqueue_s


def serve(torch, spec, dev, launches) -> tuple:
    """The serve phase (11 in the module docstring); returns (the
    flash_attention launches of the whole phase, theta on the host,
    request 0's (tokens, logits) on the host) for the shard phase."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.serve import build_serve_setup
    torch.cuda.reset_peak_memory_stats()
    setup = build_serve_setup(spec, ShapeCfg("prefill", SERVE_SEQ,
                                             SERVE_BATCH), device=dev)
    setup.model.init_(SERVE_SEED)
    cfg = setup.model.cfg
    first, total = None, 0
    for rid in list(range(REQUESTS)) + [0]:
        gen = torch.Generator(device=dev).manual_seed(1000 + rid)
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ),
                                device=dev, generator=gen)
        toks, logits, prefill_s, decode_s, enqueue_s = serve_request(
            torch, setup, prompts, launches, cfg.num_layers)
        total += launches["flash_attention"]
        peak = torch.cuda.max_memory_allocated()
        print(json.dumps({
            "path": "serve", "request": rid, "prefill_s": prefill_s,
            "prefill_tokens_per_s": SERVE_BATCH * SERVE_SEQ / prefill_s,
            "decode_ms_per_token": decode_s / NEW_TOKENS * 1e3,
            "decode_tokens_per_s": SERVE_BATCH * NEW_TOKENS / decode_s,
            "decode_enqueue_ms_per_token": enqueue_s / NEW_TOKENS * 1e3,
            "peak_memory_bytes": peak,
            "tokens": toks[:4, :8].tolist()}), flush=True)
        if first is None:
            first = (toks, logits)
        elif rid == 0:
            if not (torch.equal(toks, first[0]) and same(logits, first[1])):
                fail("serve: request 0 served again gave other tokens or "
                     "other logits' bits")
        del toks, logits
    print(f"serve: gemma2-2b {cfg.num_layers} layers, {REQUESTS} requests "
          f"of {SERVE_BATCH} x {SERVE_SEQ} tokens + {NEW_TOKENS} decode "
          f"steps, then request 0 again bit for bit; flash_attention "
          f"launches {total}", flush=True)
    return total, setup.model.theta.cpu(), tuple(t.cpu() for t in first)


# --- the shard phase (16 in the module docstring) ---------------------------

SHARD_MESHES = ((1, 4), (2, 2))
# the logits' largest gap to the one-device serve's, over its largest
# magnitude.  tools/shard_gap.py (gemma2-2b at full width, bf16) measured
# it at 0.83-1.25% on the CPU (2, 4, 8 layers, S 128) and 2.08-2.29% on an
# H100 at full depth (B 4, S 8192), where the one-device bf16 serve sits
# SHARD_BF16_ERR off its own f32 run (26 layers; 4.95% at 8): the sharded
# sums (f32 sums of bf16 partial products, rounded once) may move the
# logits by at most half what bf16 itself moves them
SHARD_BF16_ERR = 0.0716
SHARD_TOL = SHARD_BF16_ERR / 2


def shard_run(torch, setup, prompts, toks0, launches) -> dict:
    """Request 0's prompt through the sharded prefill, then NEW_TOKENS
    decode steps fed phase 11's greedy tokens (step i: toks0[:, i], the
    token phase 11 fed it), the counts reset just before: flash_attention
    once a layer a device in the prefill, every launch on the tensor-core
    route, none in the decode.  Returns the whole logits of every step
    (host), each device's caches, the seconds, and the flash_attention
    count as read after the decode."""
    from repro_torch.kernels.common import flash_routes
    n = setup.model.cfg.num_layers * setup.mesh.layout.size
    torch.cuda.synchronize()
    for counts in (launches, flash_routes):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    logits, caches = setup.prefill_step(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if dict(launches) != {**{k: 0 for k in launches}, "flash_attention": n}:
        fail(f"shard prefill: launch counts {dict(launches)}, want "
             f"flash_attention x {n}")
    if flash_routes != {"tensor_core": n, "cuda_core": 0}:
        fail(f"shard prefill: flash_attention routes {flash_routes}, want "
             f"all {n} on the tensor cores")
    steps = [logits]
    t0 = time.perf_counter()
    for i in range(NEW_TOKENS):
        logits, caches = setup.decode_step(caches, toks0[:, i:i + 1],
                                           SERVE_SEQ + i)
        steps.append(logits)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if launches["flash_attention"] != n or sum(launches.values()) != n:
        fail(f"shard decode: launch counts {dict(launches)}, want none "
             f"beyond the prefill's")
    for c in caches:
        want_pos = torch.arange(SERVE_SEQ, device=dev_of(c),
                                dtype=torch.int32)
        want_pos[:NEW_TOKENS] += SERVE_SEQ  # ring slots pos % S of the decode
        if not bool((c["kv"]["pos"] == want_pos).all()):
            fail("shard: cache positions are not the ring JAX writes")
    whole = torch.stack([setup.full_logits(p) for p in steps])
    return {"logits": whole, "caches": caches, "prefill_s": prefill_s,
            "decode_s": decode_s, "enqueue_s": enqueue_s,
            "launches": launches["flash_attention"]}


def dev_of(cache) -> "torch.device":
    return cache["kv"]["pos"].device


def shard_bytes(torch, setup, spec, prompts, caches) -> dict:
    """(a): what each device holds, its theta shard, its cache blocks
    after the prefill and its int32 token blocks of the prefill and a
    decode step, against `serve_specs` on the mesh's layout, exactly."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.serve import _batch_blocks, part_bytes, \
        serve_specs

    def held(tree):
        if isinstance(tree, dict):
            return sum(held(v) for v in tree.values())
        return tree.numel() * tree.element_size()
    shape = ShapeCfg("prefill", SERVE_SEQ, SERVE_BATCH)
    layout = setup.mesh.layout
    d = part_bytes(serve_specs(spec, shape, layout, "decode")["parts"])
    p = part_bytes(serve_specs(spec, shape, layout, "prefill")["parts"])
    want = {"params": d["params"], "caches": d["caches"],
            "prefill": p["inputs"], "decode": d["inputs"]}
    pre = _batch_blocks(setup.mesh, setup.batch_sharding, prompts)
    dec = _batch_blocks(setup.mesh, setup.batch_sharding, prompts[:, :1])
    for j, (par, c, a, b) in enumerate(zip(setup.model.params(), caches,
                                           pre, dec)):
        got = {"params": held(par), "caches": held(c), "prefill": held(a),
               "decode": held(b)}
        if got != want:
            fail(f"shard {layout.shape}: device {j} holds {got}, "
                 f"serve_specs says {want}")
    return want


def shard_phase(torch, ref, fa, gen, spec, dev, launches, theta, first
                ) -> dict:
    """Phase 16: gemma2-2b at full width and depth sharded in-process on
    the card, on each of SHARD_MESHES, from phase 11's theta (on the
    host; no new draw) and request 0's tokens and logits; then B8 at
    each mesh's per-device shape.  Returns {"counts", "flash"}."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.core.cocoef import flat_layout
    from repro_torch.launch.mesh import MeshLayout, local_mesh
    from repro_torch.launch.serve import build_serve_setup
    from repro_torch.nn.transformer import param_shapes
    cfg = spec.config
    toks0, logits0 = (t.to(dev) for t in first)
    state = flat_layout(param_shapes(cfg), 1, GROUP).views(theta)
    gen0 = torch.Generator(device=dev).manual_seed(1000)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ),
                            device=dev, generator=gen0)
    feeds = toks0
    top2 = logits0.float().topk(2, -1).values           # (steps, B, 2)
    scale = logits0.float().abs().amax((1, 2))           # (steps,)
    clear = (top2[..., 0] - top2[..., 1]) > 2 * SHARD_TOL * scale[:, None]
    del top2
    counts, out = {}, {}
    for dm in SHARD_MESHES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        layout = MeshLayout(("data", "model"), dm)
        setup = build_serve_setup(
            spec, ShapeCfg("prefill", SERVE_SEQ, SERVE_BATCH), device=dev,
            mesh=local_mesh(layout, dev))
        setup.model.load_params(state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        runs = []
        for rep in range(2):
            r = shard_run(torch, setup, prompts, feeds, launches)
            if rep == 0:
                want = shard_bytes(torch, setup, spec, prompts, r["caches"])
            r["hash"] = [bits_hash(torch, [c["kv"][k].reshape(-1)])
                         for c in r["caches"] for k in ("k", "v")]
            del r["caches"]
            runs.append(r)
        a, b = runs
        if not (same(a["logits"], b["logits"]) and a["hash"] == b["hash"]):
            fail(f"shard {dm}: the prefill and decode again gave other "
                 f"logits' or caches' bits")
        gaps = [((g.float() - w.float()).abs().max() / w.float().abs().max()
                 ).item() for g, w in zip(a["logits"], logits0)]
        if not max(gaps) <= SHARD_TOL:
            fail(f"shard {dm}: logits off the one-device serve's by "
                 f"{max(gaps):.4e} of their largest magnitude (tolerance "
                 f"{SHARD_TOL})")
        picks = a["logits"].float().argmax(-1)           # (steps, B)
        base = logits0.float().argmax(-1)
        differ = picks != base
        if bool(differ.any()):
            n_clear = int((differ & clear).sum())
            fail(f"shard {dm}: {int(differ.sum())} of {differ.numel()} "
                 f"greedy tokens differ from phase 11's ({n_clear} where "
                 f"its top-2 gap is clear of twice the tolerance)")
        key = f"shard {dm[0]}x{dm[1]}"
        counts[key] = {"flash_attention": a["launches"] + b["launches"]}
        rec = {"path": key, "mesh": list(dm), "theta_load_s": load_s,
               "prefill_s": a["prefill_s"],
               "prefill_tokens_per_s": SERVE_BATCH * SERVE_SEQ /
               a["prefill_s"],
               "decode_ms_per_token": a["decode_s"] / NEW_TOKENS * 1e3,
               "decode_enqueue_ms_per_token": a["enqueue_s"] / NEW_TOKENS
               * 1e3,
               "repeat_prefill_s": b["prefill_s"],
               "repeat_decode_ms_per_token": b["decode_s"] / NEW_TOKENS
               * 1e3,
               "flash_attention_per_prefill": a["launches"],
               "max_gap": max(gaps), "tolerance": SHARD_TOL,
               "tokens_equal": int((~differ).sum()),
               "tokens": differ.numel(), "tokens_clear": int(clear.sum()),
               "device_bytes": want,
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        print(json.dumps(rec), flush=True)
        out[key] = rec
        del setup, runs, a, b
        settle(torch, f"the shard phase on {dm}")
    flash = {}
    for dm, (B, H, Hkv) in zip(SHARD_MESHES, ((SERVE_BATCH, 2, 1),
                                             (SERVE_BATCH // 2, 4, 2))):
        key = f"shard {dm[0]}x{dm[1]}"
        flash[key] = {"B": B, "H": H, "Hkv": Hkv,
                      "launches": counts[key]["flash_attention"],
                      "launches_per_prefill": out[key][
                          "flash_attention_per_prefill"],
                      **flash_at_slice(torch, ref, fa, gen, dev, cfg, B, H,
                                       Hkv)}
        settle(torch, f"flash_attention at the shard {dm} shape")
    print(f"shard: gemma2-2b {cfg.num_layers} layers on "
          f"{[list(m) for m in SHARD_MESHES]} in-process, request 0 "
          f"prefilled and decoded twice, bits equal; B8 at one device's "
          f"shape: {json.dumps(flash)}", flush=True)
    return {"counts": counts, "flash": flash}


def attention_layers(cfg) -> int:
    """The GQA attention layers a prefill of `cfg` runs through
    flash_attention: every block of the dense and MoE stacks, the shared
    block once a group in the hybrid, none with MLA or in the xLSTM."""
    if cfg.family in ("dense", "moe"):
        return cfg.num_layers
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_period
    return 0


def serve_cell(torch, key: str, dev, launches) -> dict:
    """One cell of phase 12 (SERVE_CELLS): the setup at the cell's depth
    and shape, theta drawn (JAX's theta0) or taken from phase 10, its
    requests and request 0 again (the same tokens and logits' bits); the
    embeddings archs' prompts are seeded normal embeddings * 0.02 drawn on
    the card, their decode inputs (B, 1, d) drawn as their train batches
    are (`prng.normal_bf16` * 0.02, a key per request).  Prints each
    request's numbers; returns the cell's summary, with the
    flash_attention launches its requests counted."""
    import numpy as np
    from repro_torch.configs import REGISTRY, ShapeCfg
    from repro_torch.core import prng
    from repro_torch.launch.serve import build_serve_setup
    from repro_torch.nn.transformer import num_params
    arch, layers, B, S, requests, theta = SERVE_CELLS[key]
    spec = REGISTRY[arch]
    full = spec.config.num_layers
    if layers:
        spec = dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, num_layers=layers))
    if key in SERVE_PARAM_DTYPE:
        spec = dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, param_dtype=SERVE_PARAM_DTYPE[key]))
    torch.cuda.reset_peak_memory_stats()
    setup = build_serve_setup(spec, ShapeCfg("prefill", S, B), device=dev)
    cfg = setup.model.cfg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checked = None
    if theta == "init":
        setup.model.init_(SERVE_SEED)
    elif isinstance(HELD_THETA[theta], dict):
        setup.model.load_params(HELD_THETA.pop(theta))
    else:                         # a flat theta0 rounded to this dtype
        held, flat = HELD_THETA.pop(theta), setup.model.theta
        for i in range(0, flat.numel(), CHUNK):
            flat[i:i + CHUNK].copy_(held[i:i + CHUNK])
        del held
    torch.cuda.synchronize()
    theta_s = time.perf_counter() - t0
    if theta != "init" and key in SERVE_PARAM_DTYPE:
        checked = check_bf16_init(torch, setup.model, SERVE_SEED)
    n_attn = attention_layers(cfg)
    embeddings = cfg.input_mode != "tokens"
    path = f"serve {arch}" + (" bf16" if key in SERVE_PARAM_DTYPE else "")
    first, rows = None, []
    for rid in list(range(requests)) + [0]:
        gen = torch.Generator(device=dev).manual_seed(1000 + rid)
        feeds = None
        if embeddings:
            prompts = (torch.randn((B, S, cfg.d_model), device=dev,
                                   generator=gen) * 0.02).to(torch.bfloat16)
            feeds = (prng.normal_bf16(prng.PRNGKey(2000 + rid),
                                      (NEW_TOKENS, B, 1, cfg.d_model))
                     * torch.tensor(0.02, dtype=torch.bfloat16)).to(dev)
        else:
            prompts = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                                    generator=gen)
        toks, logits, prefill_s, decode_s, enqueue_s = serve_request(
            torch, setup, prompts, launches, n_attn, feeds)
        row = {"path": path, "request": rid, "prefill_s": prefill_s,
               "prefill_tokens_per_s": B * S / prefill_s,
               "decode_ms_per_token": decode_s / NEW_TOKENS * 1e3,
               "decode_tokens_per_s": B * NEW_TOKENS / decode_s,
               "decode_enqueue_ms_per_token": enqueue_s / NEW_TOKENS * 1e3,
               "flash_attention": launches["flash_attention"],
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "tokens": toks[:4, :8].tolist()}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if first is None:
            first = (toks, logits)
        elif rid == 0 and not (torch.equal(toks, first[0])
                               and same(logits, first[1])):
            fail(f"serve {arch}: request 0 served again gave other tokens "
                 f"or other logits' bits")
        del toks, logits, prompts, feeds
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    if peak > 80e9:
        fail(f"serve {arch}: peak {peak} B over 80 GB")
    if any(c[5] == key for c in SERVE_CELLS.values()):
        # the dtypes phase serves this theta0 rounded to bf16
        HELD_THETA[key] = hold_bf16(torch, setup.model.theta)
    n = num_params(cfg)
    pbytes = setup.model.theta.element_size()
    out = {"arch": arch, "path": path,
           "layers": f"{cfg.num_layers} of {full}",
           "batch": B, "prompt": S, "params": n, "theta": theta,
           "theta_s": theta_s, "requests": requests + 1,
           "flash_attention_per_prefill": n_attn,
           "flash_attention": sum(r["flash_attention"] for r in rows),
           "peak_memory_bytes": peak, "total_memory": total,
           "prefill_s": [r["prefill_s"] for r in rows],
           "decode_ms_per_token": [r["decode_ms_per_token"] for r in rows],
           "decode_enqueue_ms_per_token": [
               r["decode_enqueue_ms_per_token"] for r in rows],
           "param_dtype": str(setup.model.theta.dtype),
           "bf16_leaves_equal_init": checked,
           # every decode step reads all theta once, and with f32 theta
           # an eager cast of each weight writes its bf16 copy
           "decode_floor_ms": n * pbytes / HBM_BYTES_PER_S * 1e3,
           "decode_floor_with_casts_ms": n * (pbytes + 2 * (pbytes > 2))
           / HBM_BYTES_PER_S * 1e3}
    print(f"{'dtypes: ' if key in SERVE_PARAM_DTYPE else ''}serve {key}: "
          f"{json.dumps(out)}", flush=True)
    del setup
    settle(torch, f"the {key} serve cell")
    return out


def serve_batched_check(torch, device: str = "cuda") -> dict:
    """`python -m repro_torch.launch.serve_batched` on the card: its
    default run (phi3-medium-14b's smoke config in bf16, JAX's example's
    prompts) under --metrics for 2 requests (the records and trace must
    validate), and its f32 run, whose tokens must equal the CPU's."""
    import tempfile
    from repro_torch.configs import REGISTRY
    from repro_torch.launch import serve_batched
    from repro_torch.obs import read_jsonl, validate_chrome_trace, \
        validate_record
    ap = serve_batched.build_parser()
    with tempfile.TemporaryDirectory() as tmp:
        res = serve_batched.run(ap.parse_args(
            ["--device", device, "--metrics", "--requests", "2",
             "--metrics-dir", tmp]))
        for rec in read_jsonl(res["jsonl"]):
            validate_record(rec)
        validate_chrome_trace(json.loads(Path(res["trace"]).read_text()))
    spec = REGISTRY["phi3-medium-14b"]
    f32 = dataclasses.replace(spec, smoke=dataclasses.replace(
        spec.smoke, dtype="float32"))
    got, want = (serve_batched.run(ap.parse_args(["--device", d]),
                                   spec=f32)["tokens"]
                 for d in (device, "cpu"))
    if res["tokens"].shape != (4, 8) or not (got == want).all():
        fail(f"serve_batched on the card: tokens {res['tokens'].shape}, "
             f"f32 card {got.tolist()} vs CPU {want.tolist()}")
    out = {"bf16_tokens": res["tokens"].tolist(),
           "f32_tokens": got.tolist(),
           "decode_token_ms": res["summary"]["decode_token_ms"]}
    print(f"serve_batched: {json.dumps(out)}", flush=True)
    return out


def serve_cells_phase(torch, dev, launches) -> dict:
    """Phase 12: every cell of SERVE_CELLS, one setup at a time, each
    freed before the next.  Returns {key: summary}."""
    out = {}
    for key in SERVE_CELLS:
        if settle(torch, f"the phases before the {key} serve cell") \
                > 1 << 30:
            fail("over 1 GiB still allocated before a serve cell")
        out[key] = serve_cell(torch, key, dev, launches)
    return out


def flash_at_cells(torch, ref, fa, gen, dev) -> dict:
    """B8 at one prefill layer of each GQA cell of phase 12 (phi3: B 1,
    H 40, Hkv 10, S 32768, hd 128; phi3 bf16: the same at B 4; olmoe: B 4,
    H 16, Hkv 16, S 4096, hd 128; zamba2's shared block: B 4, H 32, Hkv
    32, S 4096, hd 80;
    musicgen: B 4, H 32, Hkv 32, S 4096, hd 64; bf16, causal, no window,
    no softcap): held against the plain version, timed, and the library
    call (`library_attention`, flex_attention's own tiles at these widths)
    timed on the same inputs.
    The bound counts 4 * hd flops per unmasked pair over the bf16
    tensor-core rate, against q, k, v and o each moved once."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels.common import flash_routes
    out = {}
    for key in SERVE_CELLS:
        arch, _, B, S, _, _ = SERVE_CELLS[key]
        cfg = REGISTRY[arch].config
        if not attention_layers(cfg):
            continue
        H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        g = H // Hkv
        q, k, v = attention_inputs(torch, gen, dev, B, Hkv, g, S, hd,
                                   torch.bfloat16)
        tensor_core = flash_routes["tensor_core"]

        def kernel():
            return fa.flash_attention(q, k, v, softcap=0.0, window=0,
                                      groups=g)

        def plain():
            return ref.flash_attention_ref(q, k, v, 0.0, 0, g)
        want, plain_ms = timed_once(plain)
        got = kernel()
        torch.cuda.synchronize()
        res = compare_flash(torch, fa, got, want,
                            f"flash_attention at the {key} serve cell")
        del got
        library = library_attention(torch, q, k, v, 0.0, 0, g)
        lib_err = (library().float() - want.float()).abs().max().item()
        if not lib_err <= LIBRARY_MAX_ABS_ERR:
            fail(f"the library attention at the {key} cell is off the "
                 f"plain version by {lib_err:.3e}")
        del want
        moved, flops = bill("flash_attention", B, H, Hkv, S, hd, 0, 2)
        t_ops = flops / BF16_OPS_PER_S * 1e3
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(kernel, 5)
        res.update({"arch": arch, "B": B, "H": H, "Hkv": Hkv, "S": S,
                    "hd": hd, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": cuda_ms(library, 5),
                    "library_max_abs_err": lib_err,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes
                    else "bytes", "pairs": B * H * S * (S + 1) // 2,
                    "tflop_per_s": flops / ms / 1e9,
                    "bound_share": max(t_ops, t_bytes) / ms})
        # 1 checked + 1 warm-up + 5 timed launches
        if flash_routes["tensor_core"] - tensor_core != 7:
            fail(f"flash_attention at the {key} cell did not run on the "
                 f"tensor-core route")
        out[key] = res
        del q, k, v, library
        settle(torch, f"flash_attention at the {key} cell's shape")
    print(f"flash_attention at the serve cells' shapes: {json.dumps(out)}",
          flush=True)
    return out


# --- the dtypes phase (bf16 theta and e) -----------------------------------

def bf16_inputs(torch, gen, dev, n: int, G: int, topk: bool):
    """g (n,) bf16 and e (2, n) bf16 (row 1 a copy of row 0, the row the
    kernels update), of widely varying scale over groups of G, drawn a
    CHUNK at a time in f32 and rounded once, with the adversarial groups
    (sign) or blocks (block top-K, K) at the start and at the end."""
    g = torch.empty(n, dtype=torch.bfloat16, device=dev)
    e = torch.empty((2, n), dtype=torch.bfloat16, device=dev)
    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        mag = torch.exp(torch.rand(m // G, device=dev, generator=gen)
                        * 25 - 20).repeat_interleave(G)
        g[i:i + m] = torch.randn(m, device=dev, generator=gen) * mag
        e[0, i:i + m] = torch.randn(m, device=dev, generator=gen) * mag \
            * 0.01
    for a in (0, n - 6 * G):
        if topk:
            topk_adversarial_(g[a:a + 6 * G], e[0, a:a + 6 * G], G, K)
        else:
            adversarial_(g[a:a + 4 * G], e[0, a:a + 4 * G], G, 5e-3)
    e[1].copy_(e[0])
    return g, e


def exact(got, want, what: str) -> None:
    """Every output bit for bit (None skips one)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a is not None and b is not None and not same(a, b.to(a.dtype)):
            fail(f"{what}: output {i} differs in "
                 f"{int((bits(a) != bits(b.to(a.dtype))).sum())} entries")


def dtype_row(ms, plain_ms, moved, ops, more=None) -> dict:
    b, by = bound(moved, ops)
    return {"max_ulp": 0, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "gb_per_s": moved / ms / 1e6, **(more or {})}


def dtypes_at_slice(torch, ref, sp, tp, gen, dev, n: int) -> dict:
    """The dtypes phase's kernels at the slice's n in the train step's
    layout, each held against its plain version chunk by chunk, every
    output bit for bit (words, index sets, values, scales, bf16 e'), then
    timed: ef_sign_fused on bf16 g and e and on f32 g with bf16 e (a live
    rank and a straggler, which must leave e's bits); ef_topk_fused on
    bf16 g and e at B 256, k 8 with the ranks' k_send 8, 8, 3, 1 and a
    straggler (timed at k_send 8 and 1); sign_pack and topk_pack on bf16 g
    with gamma (COCO's gamma*g folded in, no budget and k_send 3)."""
    G, gamma = GROUP, 5e-3
    gamma_t = torch.tensor(gamma, device=dev)
    masks = torch.tensor([1.0, 0.0], device=dev)
    out = {}
    g, e = bf16_inputs(torch, gen, dev, n, G, topk=False)
    words = torch.zeros((N_CODE, n // 32), dtype=torch.uint32, device=dev)
    scales = torch.zeros((N_CODE, n // G), device=dev)
    for label, gg, gb in (("ef_sign_fused@bf16 g/e", g, 2),
                          ("ef_sign_fused@bf16 e", None, 4)):
        if gg is None:
            gg = g.float()
        for row, m in ((2, masks[1]), (1, masks[0])):
            e[1].copy_(e[0])
            sp.ef_sign_fused(gg, e[1], gamma_t, m, G,
                             out=(words[row], scales[row], e[1]))
            torch.cuda.synchronize()
            what = f"{label} at n={n} (mask={m.item()})"
            if m.item() == 0.0 and not same(e[1], e[0]):
                fail(f"{what}: a straggler's e changed")
            for i in range(0, n, CHUNK):
                j = min(i + CHUNK, n)
                w, s, _, en = ref.ef_sign_fused_ref(gg[i:j], e[0, i:j],
                                                    gamma_t, m, G)
                exact((words[row, i // 32:j // 32],
                       scales[row, i // G:j // G], e[1, i:j]),
                      (w, s, en), what)
                del w, s, en
        ms = cuda_ms(lambda: sp.ef_sign_fused(
            gg, e[1], gamma_t, masks[0], G,
            out=(words[1], scales[1], e[1])), 10)

        def plain():
            for i in range(0, n, CHUNK):
                ref.ef_sign_fused_ref(gg[i:i + CHUNK], e[0, i:i + CHUNK],
                                      gamma_t, masks[0], G)
        out[label] = dtype_row(ms, cuda_ms(plain, 2),
                               *bill("ef_sign_fused", n, G, gb, 2),
                               {"g": str(gg.dtype), "e": str(e.dtype)})
        del gg
    # B5 with gamma on bf16 g
    sp.sign_pack(g, G, out=(words[0], scales[0]), gamma=gamma_t)
    torch.cuda.synchronize()
    for i in range(0, n, CHUNK):
        j = min(i + CHUNK, n)
        exact((words[0, i // 32:j // 32], scales[0, i // G:j // G]),
              ref.sign_pack_ref(g[i:j], G, gamma_t),
              f"sign_pack(gamma) on bf16 g at n={n}")
    ms = cuda_ms(lambda: sp.sign_pack(g, G, out=(words[0], scales[0]),
                                      gamma=gamma_t), 10)

    def plain_pack():
        for i in range(0, n, CHUNK):
            ref.sign_pack_ref(g[i:i + CHUNK], G, gamma_t)
    out["sign_pack@gamma"] = dtype_row(ms, cuda_ms(plain_pack, 2),
                                       *bill("sign_pack", n, G, 2),
                                       {"g": "torch.bfloat16"})
    del g, e, words, scales

    B = BLOCK
    g, e = bf16_inputs(torch, gen, dev, n, B, topk=True)
    nb = n // B
    idx = torch.zeros((N_CODE, nb, K), dtype=torch.uint16, device=dev)
    val = torch.zeros((N_CODE, nb, K), device=dev)
    sc = torch.zeros((N_CODE, nb), device=dev)
    ks = DRIVER_K_BUDGETS                   # 8, 8, 3, 1

    def launch(r, m, ksend):
        tp.ef_topk_fused(g, e[1], gamma_t, m, K, B,
                         out=(idx[r], val[r], sc[r], e[1]), k_send=ksend)

    for r, m in ((0, masks[0]), (1, masks[1]), (2, masks[0]),
                 (3, masks[0])):
        e[1].copy_(e[0])
        launch(r, m, ks[r])
        torch.cuda.synchronize()
        what = (f"ef_topk_fused@bf16 g/e at n={n} (k_send={ks[r]}, "
                f"mask={m.item()})")
        if m.item() == 0.0 and not same(e[1], e[0]):
            fail(f"{what}: a straggler's e changed")
        for i in range(0, n, CHUNK):
            j = min(i + CHUNK, n)
            want = ref.ef_topk_fused_ref(g[i:j], e[0, i:j], gamma_t, m, K, B,
                                         k_send=ks[r])
            compare_topk((idx[r, i // B:j // B], val[r, i // B:j // B],
                          sc[r, i // B:j // B], None, e[1, i:j]), want, what)
            del want
    ms8 = cuda_ms(lambda: launch(0, masks[0], None), 10)
    ms1 = cuda_ms(lambda: launch(3, masks[0], 1), 10)

    def plain_ef():
        for i in range(0, n, CHUNK):
            ref.ef_topk_fused_ref(g[i:i + CHUNK], e[0, i:i + CHUNK],
                                  gamma_t, masks[0], K, B)
    out["ef_topk_fused@bf16 g/e"] = dtype_row(
        ms8, cuda_ms(plain_ef, 2), *bill("ef_topk_fused", n, B, K, 2, 2),
        {"g": "torch.bfloat16", "e": "torch.bfloat16",
         "ms_k_send_1": ms1, "k_send_checked": list(ks)})
    # B6 with gamma on bf16 g
    for r, ksend in ((0, None), (2, 3)):
        tp.topk_pack(g, K, B, out=(idx[r], val[r], sc[r]), k_send=ksend,
                     gamma=gamma_t)
        torch.cuda.synchronize()
        for i in range(0, n, CHUNK):
            j = min(i + CHUNK, n)
            compare_topk((idx[r, i // B:j // B], val[r, i // B:j // B],
                          sc[r, i // B:j // B]),
                         ref.topk_pack_ref(g[i:j], K, B, ksend, gamma_t),
                         f"topk_pack(gamma) on bf16 g at n={n}, k_send "
                         f"{ksend}")
    ms = cuda_ms(lambda: tp.topk_pack(g, K, B, out=(idx[0], val[0], sc[0]),
                                      gamma=gamma_t), 10)

    def plain_topk():
        for i in range(0, n, CHUNK):
            ref.topk_pack_ref(g[i:i + CHUNK], K, B, None, gamma_t)
    out["topk_pack@gamma"] = dtype_row(ms, cuda_ms(plain_topk, 2),
                                       *bill("topk_pack", n, B, K, 2,
                                             gamma=True),
                                       {"g": "torch.bfloat16"})
    del g, e, idx, val, sc
    return out


def dtype_paths(name: str) -> tuple:
    """The dtypes phase's gemma2-2b setups: (TrainRun knobs, (compressor
    and mode, paths as `setup_paths` gives them))."""
    sign = {"ef_sign_fused": N_CODE, "sign_decode_reduce": 1}
    block = {"ef_topk_fused": N_CODE, "topk_decode_reduce": 1}
    if name == "sign":
        return BF16, (("sign", "cocoef"), [
            ("bf16 sign", "cocoef", None, "float32", DTYPE_STEPS, sign),
            ("bf16 sign coco", "coco", None, "float32", DTYPE_SHORT_STEPS,
             {"sign_pack": N_CODE, "sign_decode_reduce": 1})])
    if name == "block_topk":
        return BF16, (("block_topk", "cocoef"), [
            ("bf16 block_topk", "cocoef", None, "float32", DTYPE_STEPS,
             block),
            ("bf16 block_topk budgets", "cocoef", K_BUDGETS, "float32",
             DTYPE_SHORT_STEPS, block),
            ("bf16 block_topk coco", "coco", None, "float32",
             DTYPE_SHORT_STEPS,
             {"topk_pack": N_CODE, "topk_decode_reduce": 1})])
    return {"ef_dtype": "bfloat16"}, (("sign", "cocoef"), [
        ("ef bf16 sign", "cocoef", None, "float32", DTYPE_SHORT_STEPS,
         sign)])


def olmoe_bf16(torch, dev, launches) -> dict:
    """olmoe-1b-7b at full width and OLMOE_BF16_LAYERS of 16 layers with
    bf16 theta and e, through `build_train_setup` on the sign wire at
    g 32, OLMOE_BF16_STEPS steps; prints theta0's seconds, the steps and
    the peak.  Returns the path's launch counts."""
    from repro_torch.configs import REGISTRY, ShapeCfg
    from repro_torch.launch.train import TrainRun, build_train_setup
    from repro_torch.nn.transformer import num_params
    spec = REGISTRY["olmoe-1b-7b"]
    spec = dataclasses.replace(
        spec, config=dataclasses.replace(spec.config,
                                         num_layers=OLMOE_BF16_LAYERS),
        coding=dataclasses.replace(spec.coding, group_size=32))
    torch.cuda.reset_peak_memory_stats()
    setup = build_train_setup(spec, ShapeCfg("train", SEQ_LEN, GLOBAL_BATCH),
                              TrainRun(base_lr=5e-3, compressor="sign",
                                       **BF16),
                              n_code=N_CODE, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e = setup.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    path = "bf16 olmoe"
    stats = {}
    got = train_path(torch, setup, e, 0, OLMOE_BF16_STEPS, path,
                     {"ef_sign_fused": N_CODE * OLMOE_BF16_STEPS,
                      "sign_decode_reduce": OLMOE_BF16_STEPS}, launches,
                     stats)
    peak = torch.cuda.max_memory_allocated()
    PEAKS[path] = peak
    cfg = setup.model.cfg
    out = {"layers": f"{cfg.num_layers} of 16", "params": num_params(cfg),
           "flat": setup.flat_pad, "theta": str(setup.model.theta.dtype),
           "e": str(e.dtype), "init_s": init_s, "peak_bytes": peak,
           "predicted_state_bytes": 17 * setup.flat_pad,
           "total_memory": torch.cuda.get_device_properties(0).total_memory,
           **stats}
    print(f"dtypes ({path}): {json.dumps(out)}", flush=True)
    del setup, e
    settle(torch, "the bf16 olmoe run")
    return {path: got}


def dtypes_phase(torch, spec, shape, n: int, dev, launches) -> dict:
    """The dtypes phase's training (module docstring): the gemma2-2b
    setups of `dtype_paths`, one at a time, then the olmoe cell.  Returns
    the launch counts of every path."""
    counts = {}
    for name in ("sign", "block_topk", "ef alone"):
        if settle(torch, f"the phases before the dtypes {name} setup") \
                > 1 << 30:
            fail("over 1 GiB still allocated before a dtypes setup")
        knobs, paths = dtype_paths(name)
        counts.update(train_wire(torch, spec, shape, name, n, dev, launches,
                                 knobs=knobs, paths=paths))
    counts.update(olmoe_bf16(torch, dev, launches))
    return counts


def hold_bf16(torch, theta) -> "torch.Tensor":
    """theta rounded once to bf16 (JAX's cast of its f32 draw), onto the
    host a CHUNK at a time."""
    host = torch.empty(theta.numel(), dtype=torch.bfloat16)
    for i in range(0, theta.numel(), CHUNK):
        host[i:i + CHUNK].copy_(theta[i:i + CHUNK].to(torch.bfloat16))
    return host


def check_bf16_init(torch, model, seed: int) -> list:
    """A few leaves of a bf16 model that took a rounded f32 theta0 against
    a bf16 `init_` of the same leaves (drawn straight into bf16 by
    `prng.normal_into`): layer 0's wq, the last layer's w_down, the
    token table's first INIT_ROWS rows.  Fails on any bit."""
    from repro_torch.core import prng
    from repro_torch.nn.transformer import init_keys
    keys = init_keys(model.cfg, prng.PRNGKey(seed))
    params = model.params()
    L = model.cfg.num_layers
    checked = []
    for name, blk in (("blocks/attn/wq", 0), ("blocks/mlp/w_down", L - 1),
                      ("embed/tok", None)):
        k, fan = keys[name]
        v = params[name]
        if blk is None:
            got = v[:INIT_ROWS].reshape(-1)
            key = k
        else:
            got = v[blk].reshape(-1)
            key = k.reshape(-1, 2)[blk]
        want = torch.empty_like(got)
        prng.normal_into(want, key, prng.init_scale(fan))
        if not same(got, want):
            fail(f"dtypes (phi3 bf16): {name} of the rounded theta0 differs "
                 f"from a bf16 init in {int((bits(got) != bits(want)).sum())}"
                 f" entries")
        where = f"rows :{INIT_ROWS}" if blk is None else blk
        checked.append(f"{name}[{where}]")
    return checked


def task_b_trial(torch, dev) -> dict:
    """Phase 14's Task B: one trial of fig7's protocol (N = M = 100, d 2,
    iid p 0.6, masks from key 1000, StochasticSign's from key 2000) on the
    card: COCO-EF with GroupedSign at gamma 3e-3 and Unbiased with
    StochasticSign at 1e-3, EXAMPLE_T steps each.  The gradients at
    theta0 must keep their bits with TF32 switched on globally and lie
    within EXAMPLE_RTOL of the CPU's largest magnitude; F(theta) after
    each of the first EXAMPLE_CHECK steps within EXAMPLE_RTOL of the
    CPU's run of the same steps.  Prints F and the test accuracy at steps
    0, 100, 200 and the last, and the seconds a step."""
    from repro_torch.core import coding, compression as C, \
        error_feedback as EF, prng
    from repro_torch.data import tasks
    N = M = 100
    W = coding.encode_weights(coding.random_allocation(0, N, M, 2), 0.6)
    gf, lf, th0, ex = tasks.classification_task(0, device=dev)
    cgf, clf, cth0, _ = tasks.classification_task(0, device="cpu")
    g = gf(th0)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        g_tf32 = gf(th0)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    if not same(g, g_tf32):
        fail("Task B: the gradients changed with TF32 on globally")
    gc_ = cgf(cth0)
    gap = float((g.cpu() - gc_).abs().max() / gc_.abs().max())
    if gap > EXAMPLE_RTOL:
        fail(f"Task B: the card's gradients {gap} of the largest magnitude "
             f"from the CPU's")
    out = {"grad_rel_gap": gap, "tf32_on_same_bits": True}
    for method, comp, gamma in (("cocoef", C.GroupedSign(), 3e-3),
                                ("unbiased", C.StochasticSign(), 1e-3)):
        step = getattr(EF, f"{method}_step")
        st, cst = EF.EFState.init(th0, N), EF.EFState.init(cth0, N)
        rec, gaps, secs = {}, [], []
        for t in range(EXAMPLE_T):
            mask = coding.straggler_mask(prng.PRNGKey(1000), t, N, 0.6)
            kk = (prng.fold_in(prng.PRNGKey(2000), t) if comp.unbiased
                  else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = step(st, gf, W, mask, gamma, comp, step=t, key=kk)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if t < EXAMPLE_CHECK:
                cst = step(cst, cgf, W, mask, gamma, comp, step=t, key=kk)
                a, b = lf(st.theta), clf(cst.theta)
                gaps.append(abs(a - b) / abs(b))
            if t in (0, 100, 200, EXAMPLE_T - 1):
                loss = lf(st.theta)
                test_loss, acc = ex["test_metrics"](st.theta)
                if not math.isfinite(loss):
                    fail(f"Task B {method} step {t}: F = {loss}")
                rec[t] = {"F": loss, "test_loss": test_loss,
                          "test_acc": acc}
                print(f"examples: Task B {method} step {t}: F(theta) = "
                      f"{loss:.4f}, test loss {test_loss:.4f}, test "
                      f"accuracy {acc:.4f}", flush=True)
        if max(gaps) > EXAMPLE_RTOL:
            fail(f"Task B {method}: F over the first {EXAMPLE_CHECK} steps "
                 f"{max(gaps)} from the CPU's (relative)")
        out[method] = {"gamma": gamma, "record": rec,
                       "s_per_step": sum(secs) / len(secs),
                       "s_per_step_min_max": [min(secs), max(secs)],
                       "cpu_rel_gap": max(gaps)}
    return out


# the CPU's quickstart run, in a child process beside the card's work: it
# prints JAX's lines, then its (step, F) pairs as the last line
QUICKSTART_CPU = (
    "import json, sys; sys.path.insert(0, sys.argv[1]); import torch; "
    "torch.set_num_threads(4); "
    "from repro_torch.launch import quickstart; "
    "print(json.dumps(quickstart.main('cpu')))")


def quickstart_check(torch, cpu_run) -> dict:
    """Phase 14's quickstart: `launch.quickstart.main` on the card, all
    301 steps, against cpu_run, the child process running it on the CPU:
    F(theta) at every printed step equal."""
    from repro_torch.launch import quickstart
    t0 = time.perf_counter()
    card = quickstart.main("cuda")
    secs = {"cuda": time.perf_counter() - t0}
    out, _ = cpu_run.communicate(timeout=300)
    secs["cpu (child, waited)"] = time.perf_counter() - t0
    if cpu_run.returncode != 0:
        fail(f"quickstart on the CPU exited {cpu_run.returncode}")
    cpu = json.loads(out.strip().splitlines()[-1])
    card = {k: [list(x) for x in v] for k, v in card.items()}
    if card != cpu:
        fail(f"quickstart: the card's F(theta) {card} differ from the "
             f"CPU's {cpu}")
    return {"s": secs, "F": card, "card == cpu": True}


def prefill_check(torch, dev) -> dict:
    """Phase 14's cache builders: `nn.layers.prefill_kv` (gemma2-2b's and
    qwen1.5-110b's smoke widths, the latter with qkv bias) and
    `mla_prefill` (deepseek-v2-lite-16b's) on the card against the CPU,
    f32 compute, prompts of 5, 8 and 13 tokens into 8 slots, bf16 and f32
    caches: pos equal, bf16 values within one bf16 ulp, f32 within
    EXAMPLE_RTOL of the largest magnitude."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.nn import layers as L
    rng = np.random.default_rng(0)
    worst = {}
    for arch in ("gemma2-2b", "qwen1.5-110b", "deepseek-v2-lite-16b"):
        cfg = REGISTRY[arch].smoke.scaled(dtype="float32")
        d, H, Hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
        if cfg.family == "deepseek":
            shapes = {"w_dkv": (d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                      "kv_norm": (cfg.kv_lora_rank,)}
            fn = L.mla_prefill
        else:
            shapes = {"wq": (d, H, hd), "wk": (d, Hkv, hd),
                      "wv": (d, Hkv, hd)}
            if cfg.qkv_bias:
                shapes.update(bq=(H, hd), bk=(Hkv, hd), bv=(Hkv, hd))
            fn = L.prefill_kv
        p = {k: torch.from_numpy((rng.standard_normal(v) * d ** -0.5)
                                 .astype(np.float32))
             for k, v in shapes.items()}
        pd = {k: v.to(dev) for k, v in p.items()}
        gap = 0.0
        for S in (5, 8, 13):
            x = torch.from_numpy(rng.standard_normal((2, S, d)).astype(
                np.float32))
            for cache in (torch.bfloat16, torch.float32):
                want = fn(p, x, cfg, 8, cache)
                got = fn(pd, x.to(dev), cfg, 8, cache)
                if not torch.equal(got["pos"].cpu(), want["pos"]):
                    fail(f"{fn.__name__} ({arch}, S {S}): pos differs")
                for k in want:
                    if k == "pos":
                        continue
                    a, b = got[k].cpu().float(), want[k].float()
                    if cache == torch.bfloat16:
                        big = torch.maximum(a.abs(), b.abs())
                        ulp = torch.exp2(torch.floor(torch.log2(torch.where(
                            big > 0, big, 1.0))) - 7)
                        if not bool(((a - b).abs() <= ulp).all()):
                            fail(f"{fn.__name__} ({arch}, S {S}): {k} more "
                                 f"than one bf16 ulp from the CPU's")
                    else:
                        r = float((a - b).abs().max() / b.abs().max())
                        gap = max(gap, r)
                        if r > EXAMPLE_RTOL:
                            fail(f"{fn.__name__} ({arch}, S {S}): {k} {r} "
                                 f"of the largest magnitude from the CPU's")
        worst[arch] = gap
    return {"f32_rel_gap": worst}


def elastic_check(torch, ref, sp, gen, dev, launches) -> tuple:
    """Phase 14's elastic restart (`launch.elastic_restart.run`) at full
    width and ELASTIC_LAYERS of olmoe-1b-7b's 16 layers: ELASTIC_STEPS
    steps on 4 coding ranks, the checkpoint (raw, under the temp dir,
    removed after), ELASTIC_STEPS on 2.  The launch counts are reset just
    before and read just after: 4 ef_sign_fused a phase-1 step, 2 a
    phase-2 step, one sign_decode_reduce a step (each step's stage-2
    spans say which); phase 1's e rows of ranks 0 and 1 hash equal to the
    restored rows, each rescaled row equals its restored row cut to the
    new flat size, the rest is zero; every loss finite.  Then
    ef_sign_fused at phase 1's n (g 32) and sign_decode_reduce at N = 4
    and N = 2, held against their plain versions and timed.  Returns
    (the path's launch counts, the held kernels)."""
    from repro_torch.launch import elastic_restart as er
    S = ELASTIC_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in launches:
        launches[k] = 0
    res = er.run(smoke=False, layers=ELASTIC_LAYERS, steps_1=S, steps_2=S,
                 device="cuda", digest=lambda rows: bits_hash(torch, rows))
    torch.cuda.synchronize()
    got = {k: v for k, v in launches.items() if v}
    want = {"ef_sign_fused": 4 * S + 2 * S, "sign_decode_reduce": 2 * S}
    if got != want:
        fail(f"elastic restart: launch counts {got}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    info = res["resume"]
    p1, p2 = res["phase1"], res["phase2"]
    for phase, spans in ((p1, 5), (p2, 3)):
        for r in phase["steps"]:
            if len(r["kernel_spans_ms"]) != spans:
                fail(f"elastic restart step {r['step']}: "
                     f"{len(r['kernel_spans_ms'])} stage-2 spans, want "
                     f"{spans}")
            if not math.isfinite(r["loss"]):
                fail(f"elastic restart step {r['step']}: loss {r['loss']}")
    if res["e_digest"][0] != res["e_digest"][1]:
        fail("elastic restart: the restored e rows of ranks 0 and 1 differ "
             "from phase 1's")
    if not (info["e_rows_equal"] and info["e_tail_zero"]):
        fail("elastic restart: the rescaled e is not the restored rows cut "
             "to the new flat size and zeros")
    if not all_finite(torch, [res["setup"].model.theta] + list(res["e"])):
        fail("elastic restart: non-finite theta or e after phase 2")
    out = {"layers": f"{ELASTIC_LAYERS} of 16",
           "params": res["setup"].model.layout.total,
           "flat_pad": [p1["flat_pad"], p2["flat_pad"]],
           "init_s": p1["init_s"], "launches": got, "peak_bytes": peak,
           "ckpt_bytes": res["ckpt"]["bytes"],
           "save_s": res["ckpt"]["save_s"],
           "restore_s": info["restore_s"], "rescale_s": info["rescale_s"],
           "rates_after_resize": res["rates"].tolist(),
           "e_rows_hash_equal": True, "device": smi_line()}
    for name, phase in (("phase1", p1), ("phase2", p2)):
        out[name] = {k: [r[k] for r in phase["steps"]] for k in (
            "step", "loss", "step_s", "kernel_spans_ms", "mask", "epoch")}
    print(f"examples (elastic restart): {json.dumps(out)}", flush=True)
    n1, n2 = p1["flat_pad"], p2["flat_pad"]
    del res, info, p1, p2
    settle(torch, "the elastic restart")
    held = {"ef_sign_fused": {"n": n1, "group": 32,
                              "launches": got["ef_sign_fused"],
                              **ef_at_slice(torch, ref, sp, gen, dev, n1,
                                            32)}}
    settle(torch, "ef_sign_fused at the elastic restart's n")
    for N, n in ((4, n1), (2, n2)):      # one a step of its phase
        held[f"sign_decode_reduce N={N}"] = {
            "n": n, "group": 32, "senders": N, "launches": S,
            **decode_at_slice(torch, ref, sp, gen, dev, n, 32, senders=N)}
        settle(torch, f"sign_decode_reduce at the elastic restart's N={N}")
    print(f"kernels vs plain and times on the elastic restart's wire: "
          f"{json.dumps(held)}", flush=True)
    return {"elastic restart": got}, held


def examples_phase(torch, ref, sp, gen, dev, launches) -> tuple:
    """Phase 14 (module docstring); returns (launch counts by path, the
    elastic restart's held kernels)."""
    cpu_run = subprocess.Popen([sys.executable, "-c", QUICKSTART_CPU,
                                str(SRC)], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        trial = task_b_trial(torch, dev)
        print(f"examples (Task B, {time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(trial)}", flush=True)
        settle(torch, "Task B's trial")
        quick = quickstart_check(torch, cpu_run)
    finally:
        if cpu_run.poll() is None:
            cpu_run.kill()
            cpu_run.wait()
    print(f"examples (quickstart): {json.dumps(quick)}", flush=True)
    print(f"examples (prefill_kv, mla_prefill): "
          f"{json.dumps(prefill_check(torch, dev))}", flush=True)
    if settle(torch, "quickstart and the cache builders") > 1 << 30:
        fail("over 1 GiB still allocated before the elastic restart")
    return elastic_check(torch, ref, sp, gen, dev, launches)


def all_finite(torch, rows) -> bool:
    """Every entry finite, checked CHUNK at a time: torch.isfinite makes
    an f32 |x| and two bool tensors of the input's length, 16 GB for a
    whole row here."""
    return all(bool(torch.isfinite(r[i:i + CHUNK]).all())
               for r in rows for i in range(0, r.numel(), CHUNK))


def settle(torch, after: str) -> int:
    """Free what earlier phases left (cycles, the allocator's cache) and
    print the bytes still allocated on the card."""
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"allocated after {after}: {left} B "
          f"({time.perf_counter() - T0:.1f} s in)", flush=True)
    return left


DRYRUN_CELLS = (("gemma2-2b", "train_4k", False),
                ("gemma2-2b", "train_4k", True),
                ("qwen1.5-110b", "train_4k", True),
                ("phi3-medium-14b", "decode_32k", False))
STAGE1_REPS = 2


def stage1_seconds(torch, setup, batch) -> float:
    """Host seconds of stage 1 alone: the N ranks' loss and backward into
    the flat gradient, as `train_step`'s grad_of runs them, from a
    synchronise to a synchronise."""
    m = setup.model
    inputs, weights = batch[:setup.n_inputs], setup.batch_weights(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(setup.n_code):
        m.grad.zero_()
        xs = [x[i] for x in inputs]
        loss, _ = m.loss(xs[0], weights[i], *xs[1:])
        loss.backward()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def count_hold(torch, spec, shape, setup, e, step: int) -> dict:
    """The dryrun phase's count hold on the sign setup of phase 6: one
    real step under `OpCounter` on the card, the same step (the same
    host batch, mask and step) on a meta-device setup, then stage 1 alone
    timed.  Fails unless the dot flops and every kernel charge are equal
    and the card made exactly the launches it charged."""
    from repro_torch.kernels.common import launches
    from repro_torch.launch import roofline
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.launch.train import build_train_setup
    host = setup.host_batch(step)
    counts, made = {}, {}
    t0 = time.perf_counter()
    for dev in ("cuda", "meta"):
        s = setup if dev == "cuda" else build_train_setup(
            spec, shape, setup.run, n_code=N_CODE, device="meta")
        ev = e if dev == "cuda" else torch.zeros(
            (s.n_code, s.flat_pad), device="meta")
        batch = s.batch_to_device(host)
        before = dict(launches)
        with OpCounter() as c:
            m = s.train_step(s.model, ev, batch, step)
        if dev == "cuda":
            loss = m["loss"].item()
            if not math.isfinite(loss):
                fail(f"dryrun: the counted step's loss is {loss}")
        made[dev] = {k: v - before[k] for k, v in launches.items()
                     if v != before[k]}
        counts[dev] = c.record()
    hold_s = time.perf_counter() - t0
    card, meta = counts["cuda"], counts["meta"]
    want = {"ef_sign_fused": N_CODE, "sign_decode_reduce": 1}
    charged = {k: v["launches"] for k, v in card["kernels"].items()}
    if card["dot_flops_by_dtype"] != meta["dot_flops_by_dtype"] or \
            card["kernels"] != meta["kernels"] or charged != want or \
            made["cuda"] != want or made["meta"]:
        fail(f"dryrun: the card's counts differ from the meta device's: "
             f"dot flops {card['dot_flops_by_dtype']} / "
             f"{meta['dot_flops_by_dtype']}, kernels {card['kernels']} / "
             f"{meta['kernels']}, launches made {made}")
    batch = setup.make_batch(step)
    secs = [stage1_seconds(torch, setup, batch) for _ in range(STAGE1_REPS)]
    flops = card["dot_flops_by_dtype"]
    bound_s = sum(f / roofline.PEAK_FLOPS[dt] for dt, f in flops.items())
    out = {"cell": f"gemma2-2b train seq {SEQ_LEN} batch {GLOBAL_BATCH}, "
                   f"N {N_CODE}, full width and depth, sign g {GROUP}",
           "dot_flops_card": card["dot_flops"],
           "dot_flops_meta": meta["dot_flops"],
           "dot_flops_by_dtype": flops, "kernels_card": card["kernels"],
           "bytes_eager_card": card["bytes_eager"],
           "bytes_eager_meta": meta["bytes_eager"],
           "dispatches_card": card["dispatches"],
           "dispatches_meta": meta["dispatches"], "hold_s": hold_s,
           "stage1_s": secs,
           "stage1_tflop_per_s": [card["dot_flops"] / t / 1e12
                                  for t in secs],
           "stage1_bound_s": bound_s,
           "stage1_bound_share": [bound_s / t for t in secs],
           "peaks": roofline.PEAK_FLOPS,
           "tf32": torch.backends.cuda.matmul.allow_tf32}
    print(f"dryrun: count hold card == meta, {json.dumps(out)}; "
          f"{smi_line()}", flush=True)
    return out


def dryrun_phase() -> dict:
    """`launch.dryrun.run_cell` of DRYRUN_CELLS (host work on the meta
    device), each record's line printed; fails unless each is ok."""
    from repro_torch.launch import dryrun
    res = {}
    for arch, shape, multi in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, multi)
        print(f"dryrun: {dryrun.summary(rec)}", flush=True)
        if rec["status"] != "ok":
            fail(f"dryrun: {arch} {shape} "
                 f"{'multi' if multi else 'single'}: {rec.get('error')}")
        res[f"{arch} {shape} {rec['mesh']}"] = {
            k: rec.get(k) for k in ("n_code", "b_loc", "flat_pad",
                                    "effective_mode", "cache_len",
                                    "total_s")}
        res[f"{arch} {shape} {rec['mesh']}"].update(
            argument_bytes=rec["memory"]["argument_bytes"],
            flops_ideal_per_device=rec["cost"]["flops_ideal_per_device"],
            wire_bytes_per_device=rec["collectives"][
                "wire_bytes_per_device"],
            kernels=rec["kernels"], roofline=rec["roofline"])
    print(f"dryrun: cells {json.dumps(res)}", flush=True)
    return res


def main() -> None:
    # the driver's all-flags run peaks at 81.5 GB of the card's 85.0e9 B;
    # after the earlier phases fixed allocator segments left 3.6 GiB
    # reserved in pieces that its 1.46 GiB logits gradient did not fit
    # (out of memory), so segments grow in place instead
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch next to {Path(__file__).name}")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import REGISTRY, ShapeCfg
    from repro_torch.core.cocoef import padded_size
    from repro_torch.kernels import build, flash_attention as fa, ref, \
        sign_pack as sp, topk_pack as tp
    from repro_torch.kernels.common import launches
    from repro_torch.launch import train_e2e
    from repro_torch.launch.device_parity import loss_no_sync, \
        moe_repeat, serve_parity, step_parity
    from repro_torch.nn.transformer import num_params

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"device: {smi}", flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, "
          f"{', '.join(build.SOURCES)})", flush=True)
    report = build.ptxas_report("flash_attention_sm90")
    ptxas = ptxas_summary(report)
    print(f"ptxas (flash_attention_sm90): {json.dumps(ptxas)}; warnings: "
          f"{[ln for ln in report.splitlines() if 'warning' in ln]}",
          flush=True)
    if any(r["spill_bytes"] for r in ptxas):
        fail("the tensor-core flash_attention kernel spills registers")

    gen = torch.Generator(device=dev).manual_seed(0)
    checks = {"ef_sign_fused": check_ef(torch, ref, sp, gen, dev),
              "sign_decode_reduce": check_decode(torch, ref, sp, gen, dev)}
    check_topk(torch, ref, tp, gen, dev)
    n_shapes = check_decode_shapes(torch, ref, tp, gen, dev)
    check_pack(torch, ref, sp, tp, gen, dev)
    checks["flash_attention"] = check_flash(torch, ref, fa, gen, dev)
    print(f"kernels vs plain at n={CHECK_N}: {json.dumps(checks)}; "
          f"block top-K kernels bit-equal (f32 and bf16 values, budget "
          f"k_send={K_BUDGETS[3]} and none); topk_decode_reduce bit-equal"
          f" on {n_shapes} small-n tile shapes; sign_pack "
          f"and block_topk bit-equal (B in {TOPK_BLOCKS}, k in {{{K}, 32}}); "
          f"flash_attention over the adversarial sweep", flush=True)
    settle(torch, "the 2**28 checks")
    spec = REGISTRY["gemma2-2b"]
    at_slice = {"flash_attention": flash_at_slice(torch, ref, fa, gen, dev,
                                                  spec.config)}
    settle(torch, "flash_attention at the serve slice's shapes")
    n = padded_size(num_params(spec.config), N_CODE, GROUP)
    at_slice["ef_sign_fused"] = ef_at_slice(torch, ref, sp, gen, dev, n)
    settle(torch, "ef_sign_fused at the slice's n")
    at_slice["sign_decode_reduce"] = decode_at_slice(torch, ref, sp, gen,
                                                     dev, n)
    settle(torch, "sign_decode_reduce at the slice's n")
    at_slice.update(topk_at_slice(torch, ref, tp, gen, dev, n))
    settle(torch, "the block top-K kernels at the slice's n")
    at_slice.update(pack_at_slice(torch, ref, sp, tp, gen, dev, n))
    settle(torch, "sign_pack and block_topk at the slice's n")
    print(f"kernels vs plain and times at n={n}, train layout: "
          f"{json.dumps(at_slice)}", flush=True)
    # the driver's own wire (train_e2e.CODING_OVERRIDES) at its n
    wire = train_e2e.CODING_OVERRIDES
    G, B, k = wire["group_size"], wire["block_size"], wire["k_per_block"]
    n_sign = padded_size(num_params(spec.config), N_CODE, G)
    n_topk = padded_size(num_params(spec.config), N_CODE, math.lcm(G, B))
    drv = {"ef_sign_fused": {"n": n_sign, "group": G, **ef_at_slice(
        torch, ref, sp, gen, dev, n_sign, G)}}
    settle(torch, f"ef_sign_fused at the driver's n, g {G}")
    drv["sign_decode_reduce"] = {"n": n_sign, "group": G, **decode_at_slice(
        torch, ref, sp, gen, dev, n_sign, G)}
    settle(torch, f"sign_decode_reduce at the driver's n, g {G}")
    for name, r in budgets_at_slice(torch, ref, tp, gen, dev, n_topk, B, k,
                                    DRIVER_K_BUDGETS).items():
        drv[name] = {"n": n_topk, "block": B, "k": k,
                     "k_send": list(DRIVER_K_BUDGETS), **r}
    settle(torch, f"the budgeted block top-K kernels at the driver's n, "
           f"B {B}")
    print(f"kernels vs plain and times on the driver's wire, train layout: "
          f"{json.dumps(drv)}", flush=True)
    route = global_at_slice(torch, ref, tp, gen, dev, n)
    settle(torch, "the global top-K route at the slice's n")
    print(f"global top-K route (rounds of topk_pack) vs plain at n={n}, "
          f"bit for bit on the adversarial chunks: {json.dumps(route)}",
          flush=True)
    dt_slice = dtypes_at_slice(torch, ref, sp, tp, gen, dev, n)
    settle(torch, "the dtypes phase's kernels at the slice's n")
    print(f"dtypes: kernel instances vs plain and times at n={n}, train "
          f"layout, bit for bit: {json.dumps(dt_slice)}", flush=True)
    init_phase(torch, spec, dev)
    settle(torch, "the init phase")

    cases = [(mode, comp, kb, "float32") for mode in ("cocoef", "coco")
             for comp, kb in (("sign", None), ("block_topk", None),
                              ("block_topk", K_BUDGETS))]
    cases += [("cocoef", "identity", None, "float32"),
              ("cocoef", "identity", None, "bfloat16"),
              ("coco", "identity", None, "float32"),
              ("cocoef", "topk", None, "float32"),
              ("coco", "topk", None, "float32"),
              ("dense", "sign", None, "float32")]
    cases = [c + ({},) for c in cases]
    # the dtypes phase's instances on the smoke step (B1, B3, B5, B6)
    cases += [("cocoef", "sign", None, "float32", BF16),
              ("cocoef", "block_topk", K_BUDGETS, "float32", BF16),
              ("coco", "sign", None, "float32", BF16),
              ("coco", "block_topk", None, "float32", BF16),
              ("cocoef", "block_topk", None, "float32",
               {"ef_dtype": "bfloat16"})]
    for knobs, paths in bucket_setups():     # the buckets phase's configs
        setup_knobs = dict(knobs)
        comp = setup_knobs.pop("compressor")
        cases += [("cocoef", comp, None, "float32", {**setup_knobs, **rk})
                  for _, rk, _, _ in paths]
    for mode, comp, kb, wd, knobs in cases:
        try:
            parity = step_parity("cuda", compressor=comp, k_budgets=kb,
                                 mode=mode, wire_dtype=wd, **knobs)
        except AssertionError as err:
            fail(f"smoke-size step on the card vs the CPU ({mode}, {comp} "
                 f"{wd}, budgets {kb}, {knobs}): {err}")
        print(f"reference ({mode}, {comp} {wd}, budgets {kb}"
              f"{', ' + json.dumps(knobs) if knobs else ''}): "
              f"{json.dumps(parity)}", flush=True)
    parity_phase(torch, launches)
    try:
        gaps = serve_parity("cuda")
    except AssertionError as err:
        fail(f"smoke-size serving on the card vs the CPU: {err}")
    print(f"reference (serve, relative gaps): {json.dumps(gaps)}",
          flush=True)
    for arch in NEW_ARCHS:
        try:
            gaps = serve_parity("cuda", arch=arch)
        except AssertionError as err:
            fail(f"smoke-size serving of {arch} on the card vs the CPU: "
                 f"{err}")
        print(f"reference (serve {arch}, relative gaps): "
              f"{json.dumps(gaps)}", flush=True)
    for arch in NEW_ARCHS:
        comp = "block_topk" if arch in BLOCK_TOPK_ARCHS else "sign"
        try:
            parity = step_parity("cuda", arch=arch, compressor=comp)
        except AssertionError as err:
            fail(f"smoke-size step on the card vs the CPU ({arch}, "
                 f"{comp}): {err}")
        print(f"reference ({arch}, {comp}): {json.dumps(parity)}",
              flush=True)
    try:
        rep_moe = {dt: moe_repeat("cuda", dt)
                   for dt in ("float32", "bfloat16")}
    except AssertionError as err:
        fail(f"the MoE layer on the card: {err}")
    print(f"reference (MoE layer twice, bit for bit, no sync): "
          f"{json.dumps(rep_moe)}", flush=True)
    no_sync = {}
    for arch in LATER_ARCHS:
        try:
            no_sync[arch] = loss_no_sync("cuda", arch)
        except (AssertionError, RuntimeError) as err:
            fail(f"{arch}'s smoke loss and backward on the card: {err}")
    print(f"reference (smoke loss and backward, bf16, no sync): "
          f"{json.dumps(no_sync)}", flush=True)

    shape = ShapeCfg("train", SEQ_LEN, GLOBAL_BATCH)
    counts = {}
    t_dry = time.perf_counter()
    dryrun_phase()
    t_dry = time.perf_counter() - t_dry

    def hold(setup, e, step):
        nonlocal t_dry
        t = time.perf_counter()
        count_hold(torch, spec, shape, setup, e, step)
        t_dry += time.perf_counter() - t

    for wire in ("sign", "block_topk", "identity", "topk", "dense"):
        if settle(torch, f"the phases before the {wire} paths") > 1 << 30:
            fail("over 1 GiB still allocated before a train path: two "
                 "setups must not share the card")
        counts.update(train_wire(torch, spec, shape, wire, n, dev,
                                 launches, rounds=route[
                                     "b6_launches_per_call"],
                                 after=hold if wire == "sign" else None))
    print(f"dryrun: phase {t_dry:.1f} s", flush=True)
    counts.update(buckets_phase(torch, spec, shape, dev, launches))
    if settle(torch, "the buckets phase") > 1 << 30:
        fail("over 1 GiB still allocated before the nccl phase")
    nccl_phase(torch, dev, launches)
    if settle(torch, "the nccl phase") > 1 << 30:
        fail("over 1 GiB still allocated before the driver phase")
    counts.update(driver_phase(torch, spec, dev, launches))
    if settle(torch, "the driver phase") > 1 << 30:
        fail("over 1 GiB still allocated before the families phase")
    fam_counts, fam_wires = families_phase(torch, dev, launches)
    counts.update(fam_counts)
    if settle(torch, "the train paths") > 1 << 30:
        fail("over 1 GiB still allocated before the families' kernels")
    fam = families_kernels(torch, ref, sp, tp, gen, dev, fam_wires)
    if settle(torch, "the families' kernels") > 1 << 30:
        fail("over 1 GiB still allocated before the dtypes phase")
    counts.update(dtypes_phase(torch, spec, shape, n, dev, launches))
    THETA0_HOST.clear()           # host memory for phi3's theta0
    if settle(torch, "the dtypes phase") > 1 << 30:
        fail("over 1 GiB still allocated before the examples phase")
    ex_counts, ela = examples_phase(torch, ref, sp, gen, dev, launches)
    counts.update(ex_counts)
    if settle(torch, "the examples phase") > 1 << 30:
        fail("over 1 GiB still allocated before the serve path")
    n_serve, theta, first = serve(torch, spec, dev, launches)
    counts["serve prefill"] = {"flash_attention": n_serve}
    if settle(torch, "the serve phase") > 1 << 30:
        fail("over 1 GiB still allocated before the shard phase")
    shard = shard_phase(torch, ref, fa, gen, spec, dev, launches, theta,
                        first)
    del theta, first
    counts.update(shard["counts"])
    cells = serve_cells_phase(torch, dev, launches)
    serve_batched_check(torch)
    for c in cells.values():
        counts[c["path"]] = {"flash_attention": c["flash_attention"]}
    if settle(torch, "the serve cells") > 1 << 30:
        fail("over 1 GiB still allocated after the serve cells")
    cell_flash = flash_at_cells(torch, ref, fa, gen, dev)

    block_paths = ("block_topk", "block_topk b2 pipelined", "driver budgets",
                   "driver all flags", "driver metrics off",
                   "musicgen block_topk", "xlstm block_topk")
    meta = {
        "ef_sign_fused": ("sign_pack", "sign_pack.py:112", SIGN_PATHS),
        "sign_decode_reduce": ("sign_pack", "sign_pack.py:162", SIGN_PATHS),
        "ef_topk_fused": ("topk_pack", "topk_pack.py:137", block_paths),
        "topk_decode_reduce": ("topk_pack", "topk_pack.py:186",
                               block_paths),
        "topk_pack": ("topk_pack", "topk_pack.py:63",
                      ("block_topk coco", "topk", "topk coco")),
        "sign_pack": ("sign_pack", "sign_pack.py:60",
                      ("sign coco", "sign phase2 sign")),
        # on no train path: the sparsifier of ops.block_topk
        "block_topk": ("topk_pack", "topk_block.py:148", "ops.block_topk"),
        # the serve paths' bf16 kernel (f32 runs flash_attention.cu)
        "flash_attention": ("flash_attention_sm90", "flash_attention.py:67",
                            ("serve prefill",) + tuple(shard["counts"]) +
                            tuple(c["path"] for c in cells.values()
                                  if c["flash_attention_per_prefill"])),
    }
    driver_paths = {
        "ef_sign_fused": [p for p in SIGN_PATHS if p.startswith("driver")],
        "sign_decode_reduce": [p for p in SIGN_PATHS
                               if p.startswith("driver")],
        "ef_topk_fused": ["driver budgets", "driver all flags",
                          "driver metrics off"],
        "topk_decode_reduce": ["driver budgets", "driver all flags",
                               "driver metrics off"]}
    kernels = []
    for name, (src, replaces, path) in meta.items():
        r = at_slice[name]
        paths = path if isinstance(path, tuple) else (path,)
        if name == "topk_pack":       # its rounds in the global route
            r = {**r, "more": {**r.get("more", {}), **{
                f"global_route_{k}": v for k, v in route.items()}}}
        if name in drv:               # the driver's instance, own numbers
            r = {**r, "more": {**r.get("more", {}), "driver_wire": {
                "launches": sum(counts.get(p, {}).get(name, 0)
                                for p in driver_paths[name]),
                **drv[name]}}}
        errs = [drv.get(name, r)]
        for key, x in ela.items():   # the elastic restart's instances
            if key.split(" ")[0] == name:
                errs.append(x)
                r = {**r, "more": {**r.get("more", {}), "elastic_wire" + (
                    "" if key == name else f" {key.split(' ')[1]}"): x}}
        if name == "flash_attention":            # the serve cells' layers
            for key, x in shard["flash"].items():
                errs.append(x)
                r = {**r, "more": {**r.get("more", {}),
                                   key.replace(" ", "_"): x}}
            for key, x in cell_flash.items():
                errs.append(x)
                r = {**r, "more": {**r.get("more", {}), f"{key}_cell": {
                    "launches": counts[cells[key]["path"]][name],
                    "launches_per_prefill": cells[key][
                        "flash_attention_per_prefill"], **x}}}
        for arch, (path, held) in fam.items():   # the families' instances
            if name in held:
                errs.append(held[name])
                r = {**r, "more": {**r.get("more", {}), f"{arch}_wire": {
                    "launches": counts.get(path, {}).get(name, 0),
                    **held[name]}}}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{replaces}",
            "path": " + ".join(paths),
            "launches": sum(counts.get(p, {}).get(name, 0) for p in paths),
            "max_abs_err": max([checks.get(name, r)["max_abs_err"],
                                r["max_abs_err"]]
                               + [x["max_abs_err"] for x in errs]),
            "max_ulp": (max([checks.get(name, r)["max_ulp"], r["max_ulp"]]
                            + [x["max_ulp"] for x in errs])
                        if "max_ulp" in r else None),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "gb_per_s": r["gb_per_s"], "library_ms": r.get("library_ms"),
            **r.get("more", {})})
    # the dtypes phase's instances, each in a row of its own
    dtype_meta = {
        "ef_sign_fused@bf16 g/e": ("ef_sign_fused", "sign_pack",
                                   "sign_pack.py:112",
                                   ("bf16 sign", "bf16 olmoe")),
        "ef_sign_fused@bf16 e": ("ef_sign_fused", "sign_pack",
                                 "sign_pack.py:112", ("ef bf16 sign",)),
        "ef_topk_fused@bf16 g/e": ("ef_topk_fused", "topk_pack",
                                   "topk_pack.py:137",
                                   ("bf16 block_topk",
                                    "bf16 block_topk budgets")),
        "sign_pack@gamma": ("sign_pack", "sign_pack", "sign_pack.py:60",
                            ("bf16 sign coco",)),
        "topk_pack@gamma": ("topk_pack", "topk_pack", "topk_pack.py:63",
                            ("bf16 block_topk coco",)),
    }
    for label, (name, src, replaces, paths) in dtype_meta.items():
        r = dt_slice[label]
        kernels.append({
            "name": f"{name} ({label.split('@')[1]})", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{replaces}",
            "path": " + ".join(paths),
            "launches": sum(counts.get(p, {}).get(name, 0) for p in paths),
            "max_abs_err": r["max_abs_err"], "max_ulp": r["max_ulp"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "gb_per_s": r["gb_per_s"], "library_ms": None,
            **{k: v for k, v in r.items() if k not in (
                "max_abs_err", "max_ulp", "ms", "plain_ms", "bound_ms",
                "bound_by", "gb_per_s")}})
        if not kernels[-1]["launches"]:
            fail(f"{label}: no launch on the dtypes phase's paths")
    print(f"chip_smoke: {time.perf_counter() - T0:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
