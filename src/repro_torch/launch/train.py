"""The COCO-EF training step with every coding rank on one device (port of
`repro.launch.train` for the one-card slice).

  Stage 1  each coding rank's coded gradient g_i is one weighted backward
           pass (the encode weights are folded into the per-example
           weights), written into the model's one flat gradient buffer.
  Stage 2  rank by rank, the fused local step of the wire
           (ef_sign_fused on the sign wire, ef_topk_fused on the block
           top-K wire; topk_pack when the ranks have their own k budgets)
           packs gamma*g_i + e_i into rank i's payload and updates e_i in
           place; then one sender-order decode (sign_decode_reduce or
           topk_decode_reduce) writes ghat into the gradient buffer, and
           the server update theta <- theta - ghat runs in place.
           In coco mode (no error feedback) the local step is gamma*g_i
           in place and the pack only (sign_pack or topk_pack); e stays
           as it is.  Global top-K (compressor "topk", one block per
           chunk) runs the same steps through the kernels' global route
           (rounds of topk_pack).  On the dense wire (compressor
           "identity", f32 or bf16) and in dense mode (the SGC baseline:
           gamma*g_i, no compression, no error feedback) each rank's
           mask_i * C(acc_i) is added into an f32 accumulator as it is
           made, and the accumulator is ghat.

With every coding rank on one device the JAX collective's all_to_all /
decode / all_gather is one decode (`core.collectives`).  With a coding
grid (`build_train_setup(..., group=grid)`, `launch.mesh.CodingGrid`)
each process is one coding rank: it makes only its own coded rows, keeps
only its own (n,) error row, runs one backward pass and
`group_cocoef_update` (the two-phase collective over the grid's process
groups), and holds a replica of theta that every rank updates with the
same ghat, so the replicas stay bit-identical.  `num_buckets`,
`bucket_schedule`, `phase2_dtype` and `phase2_sign` work in both forms
(`core.cocoef`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.common import ArchSpec, CodingPlan, ShapeCfg
from repro_torch.core import coding
from repro_torch.core.cocoef import (SCHEDULES, CocoEFConfig, check_mode,
                                     cocoef_update, group_buffers,
                                     group_cocoef_update, payload_specs)
from repro_torch.data import pipeline
from repro_torch.kernels import ref
from repro_torch.nn.models import Model
from repro_torch.optim.optimizers import (OptimizerConfig, apply_update,
                                          init_opt_state, lr_schedule)
from repro_torch.sim.stragglers import IIDBernoulli

__all__ = ["TrainRun", "TrainSetup", "build_train_setup"]


@dataclasses.dataclass(frozen=True)
class TrainRun:
    """The knobs of the slice's run: constant learning rate (the paper's
    setting), the server optimizer, the seed of the parameters, the
    batches and the straggler masks, the mode, and JAX's wire overrides
    (the other wire knobs come from the spec's CodingPlan).

    mode: "cocoef" (the paper's method), "coco" (its baseline without
      error feedback) or "dense" (stochastic gradient coding, no
      compression).
    compressor: overrides spec.coding.compressor ("sign" | "block_topk" |
      "topk" | "identity").
    k_budgets: one block top-K budget per coding rank; overrides
      spec.coding.k_per_block and needs the block_topk wire.
    num_buckets / bucket_schedule: buckets of the flat vector and their
      issue order ("pipelined" | "serial", the same bits).
    phase2_dtype / phase2_sign: the broadcast of the aggregate ("float32"
      is the paper's; "bfloat16"; or re-packed on the sign wire)."""

    base_lr: float = 1e-3
    optimizer: OptimizerConfig = OptimizerConfig()
    seed: int = 0
    compressor: Optional[str] = None
    k_budgets: Optional[Tuple[int, ...]] = None
    mode: str = "cocoef"
    phase2_dtype: str = "float32"
    phase2_sign: bool = False
    num_buckets: int = 1
    bucket_schedule: str = "pipelined"

    def __post_init__(self):
        check_mode(self.mode)
        if self.num_buckets < 1:
            raise ValueError(f"num_buckets={self.num_buckets} must be >= 1")
        if self.bucket_schedule not in SCHEDULES:
            raise ValueError(f"unknown bucket_schedule "
                             f"{self.bucket_schedule!r}; have {SCHEDULES}")
        ref.wire_dtype(self.phase2_dtype)
        if self.k_budgets is not None and \
                any(k < 1 for k in self.k_budgets):
            raise ValueError("every per-rank k budget must be >= 1")
        if self.k_budgets is not None and len(self.k_budgets) == 0:
            raise ValueError("k_budgets must be non-empty (one per-rank "
                             "block-top-K budget per coding rank)")

    def coding_config(self, plan: CodingPlan, n_code: int) -> CocoEFConfig:
        """The wire this run codes with on `n_code` ranks: the plan's,
        with this run's overrides (JAX `TrainRun.resolve_plan`)."""
        comp = self.compressor or plan.compressor
        k_per_block = plan.k_per_block
        if self.k_budgets is not None:
            if comp != "block_topk":
                raise ValueError(
                    f"k_budgets rides the block-top-K sparse wire; the "
                    f"effective compressor is {comp!r} (pass "
                    f"compressor='block_topk' or drop k_budgets)")
            if len(self.k_budgets) != n_code:
                raise ValueError(f"k_budgets has {len(self.k_budgets)} "
                                 f"entries, the run has {n_code} coding "
                                 f"ranks")
            k_per_block = tuple(self.k_budgets)
        return CocoEFConfig(group_size=plan.group_size, mode=self.mode,
                            compressor=comp, topk_k=plan.topk_k,
                            k_per_block=k_per_block,
                            block_size=plan.block_size,
                            wire_dtype=plan.wire_dtype,
                            phase2_dtype=self.phase2_dtype,
                            phase2_sign=self.phase2_sign,
                            num_buckets=self.num_buckets,
                            bucket_schedule=self.bucket_schedule)


Batch = Tuple[torch.Tensor, torch.Tensor]    # tokens (N, b, S+1), weights


@dataclasses.dataclass
class TrainSetup:
    """Everything one run needs: the model over flat buffers, the coding
    plan, the payload buffers and the optimizer state, on one device.
    With a coding grid (`grid`) it is one coding rank's: `payload` is
    empty and `buffers` holds its (send, receive) buffers per bucket."""

    run: TrainRun
    model: Model
    n_code: int
    b_loc: int
    per_subset: int
    seq_len: int
    allocation: coding.Allocation
    W: np.ndarray                    # (N, M) f32 encode weights
    cocoef_cfg: CocoEFConfig
    straggler_process: Optional[IIDBernoulli]
    payload: Tuple[torch.Tensor, ...]     # the wire's, stacked over ranks
    opt_state: Tuple[torch.Tensor, ...]
    grid: Optional[object] = None         # launch.mesh.CodingGrid
    buffers: Optional[List] = None        # group_buffers, with a grid

    @property
    def device(self) -> torch.device:
        return self.model.theta.device

    @property
    def flat_pad(self) -> int:
        return self.model.layout.padded

    @property
    def ranks(self) -> List[int]:
        """The coding ranks this setup runs: all N, or its grid rank."""
        return ([self.grid.rank] if self.grid is not None
                else list(range(self.n_code)))

    def init_state(self) -> Optional[torch.Tensor]:
        """Random parameters from `run.seed`; returns the zero error
        vectors of its ranks ((N, n), or (n,) with a grid), or None in the
        coco and dense modes, which never read them (42.6 GB at the
        slice's n)."""
        self.model.init_(self.run.seed)
        if self.cocoef_cfg.mode != "cocoef":
            return None
        lead = () if self.grid is not None else (self.n_code,)
        return torch.zeros(lead + (self.flat_pad,), dtype=torch.float32,
                           device=self.device)

    def make_batch(self, step: int) -> Batch:
        """Tokens (R, b_loc, L+1) and weights (R, b_loc) of this setup's R
        ranks (`ranks`)."""
        toks, wts = pipeline.coded_train_batch(
            self.run.seed, step, self.allocation, self.W, self.per_subset,
            self.seq_len, self.model.cfg.vocab_size, ranks=self.ranks)
        return toks.to(self.device), wts.to(self.device)

    def mask(self, step: int) -> torch.Tensor:
        if self.straggler_process is None:
            return torch.ones(self.n_code, dtype=torch.float32)
        return self.straggler_process.mask(self.run.seed, step)

    def train_step(self, params: Model, e: Optional[torch.Tensor],
                   batch: Batch, step: int,
                   masks: Optional[torch.Tensor] = None,
                   kernel_spans: Optional[List] = None
                   ) -> Dict[str, torch.Tensor]:
        """One COCO-EF step (or COCO or SGC step, in the coco and dense
        modes); updates params.theta, e (only in cocoef mode; None is fine
        in the others) and the optimizer state in place.  masks: (N,)
        participation for this step (default: the setup's straggler
        process at `step`).  kernel_spans: see
        `cocoef_update`.  With a grid, batch and e are this rank's.
        Returns {"loss": mean loss of the setup's ranks, "losses": (R,),
        "mask": (N,)}."""
        tokens, weights = batch
        mask = (self.mask(step) if masks is None else
                torch.as_tensor(masks, dtype=torch.float32))
        mask = mask.to(self.device).contiguous()
        losses = []

        def grad_of(i: int) -> torch.Tensor:
            params.grad.zero_()
            loss, _ = params.loss(tokens[i], weights[i])
            loss.backward()
            losses.append(loss.detach())
            return params.grad

        self.coded_update(params, grad_of, e, mask, step, kernel_spans)
        ls = torch.stack(losses)
        return {"loss": ls.mean(), "losses": ls, "mask": mask}

    def coded_update(self, params: Model, grad_of,
                     e: Optional[torch.Tensor], mask: torch.Tensor, step: int,
                     kernel_spans: Optional[List] = None) -> torch.Tensor:
        """Stage 2 and the server update of one step: `cocoef_update` over
        the ranks' gradients grad_of(i) (with a grid `group_cocoef_update`
        on grad_of(0), this rank's), with ghat written into params.grad
        (on one device, on the dense wire and in dense mode ghat is the
        accumulator, payload[0]), then theta <- theta - ghat in place.
        mask: (N,) f32 on the setup's device.  Returns ghat."""
        gamma = lr_schedule("constant", self.run.base_lr)(step)
        # one copy to the device per step, made before stage 1 is queued,
        # instead of one per rank that would block the host between ranks
        gamma_dev = gamma.to(self.device)
        if self.grid is not None:
            ghat = group_cocoef_update(grad_of(0), e, mask, gamma_dev,
                                       self.cocoef_cfg, self.grid,
                                       self.buffers, out=params.grad,
                                       kernel_spans=kernel_spans)
        else:
            ghat = cocoef_update(grad_of, e, mask, gamma_dev,
                                 self.cocoef_cfg, self.payload,
                                 out=params.grad, kernel_spans=kernel_spans)
        apply_update(self.run.optimizer, params.theta, ghat, self.opt_state,
                     step, gamma)
        return ghat


def build_train_setup(spec: ArchSpec, shape: ShapeCfg,
                      run: TrainRun = TrainRun(), smoke: bool = False,
                      n_code: int = 4, device="cuda",
                      group=None) -> TrainSetup:
    """The slice's counterpart of JAX's `build_train_setup` on a
    (data=n_code, model=1) mesh: cyclic allocation with M = n_code subsets
    and d = spec.coding.redundancy, rate-aware encode weights (eq. 3 for
    the iid process), flat size padded to nd * pad_multiple * num_buckets
    (the sign group, joined with the block on the block top-K wire; nd the
    chunk ranks, n_code on one device).  With compressor "topk" the wire
    is one block of n / nd per chunk and bucket, as on JAX's mesh.
    group: a `launch.mesh.CodingGrid`; this process is then its coding
    rank only, and n_code must be the grid's size."""
    cfg = spec.smoke if smoke else spec.config
    if group is not None and n_code != group.size:
        raise ValueError(f"n_code={n_code}, the coding grid has "
                         f"{group.size} ranks")
    if n_code < 2:
        raise ValueError("the coded step needs at least 2 coding ranks")
    p = spec.coding.straggler_p
    proc = IIDBernoulli(n_code, p) if p > 0 else None
    M = n_code
    d = min(spec.coding.redundancy, n_code)
    alloc = coding.cyclic_allocation(n_code, M, d)
    W = (coding.encode_weights(alloc, rates=proc.rates()) if proc
         else coding.encode_weights(alloc, p=0.0))
    per_subset = max(1, shape.global_batch // M)
    ccfg = run.coding_config(spec.coding, n_code)

    nd = n_code if group is None else group.nd
    model = Model(cfg, chunk_ranks=nd, group_size=ccfg.pad_multiple,
                  device=device, num_buckets=ccfg.num_buckets)
    dev = model.theta.device
    n = model.layout.padded
    if group is None:
        payload, buffers = _payload_buffers(ccfg, n_code, n, dev), None
    else:
        payload, buffers = (), group_buffers(ccfg, nd, n, dev)
    return TrainSetup(
        run=run, model=model, n_code=n_code, b_loc=per_subset * d,
        per_subset=per_subset, seq_len=shape.seq_len, allocation=alloc, W=W,
        cocoef_cfg=ccfg, straggler_process=proc, payload=payload,
        opt_state=init_opt_state(run.optimizer, n, dev), grid=group,
        buffers=buffers)


def _payload_buffers(ccfg: CocoEFConfig, n_code: int, n: int,
                     device) -> Tuple[torch.Tensor, ...]:
    """Zeroed payload buffers of the run's wire for n_code ranks sharing
    the device, in the wire's dtypes (`payload_specs` per rank and bucket,
    stacked over the ranks, and over the buckets first when there are
    more than one): sign (words (N, n/32) u32, scales (N, n/g) f32); block
    or global top-K (idx (N, n/B, k_max), values (N, n/B, k_max), scales
    (N, n/B)); the dense wire and dense mode (the ghat accumulator (n,)
    f32,), since each rank's payload is folded into it as it is made."""
    if ccfg.folds:
        return (torch.zeros(n, dtype=torch.float32, device=device),)
    B = ccfg.num_buckets
    lead = (n_code,) if B == 1 else (B, n_code)
    return tuple(torch.zeros(lead + s, dtype=dt, device=device)
                 for s, dt in payload_specs(ccfg, n // B, n_code))
