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

The coding plane (JAX's): a straggler process of `sim.stragglers`, a
cyclic or rate-aware allocation and rate-aware encode weights from the
run's `PlanSpec`; with `TrainRun(elastic=True)` the step takes a live
`CodingState` (`elastic_coding_state`) whose W weights each example
through its subset id, so the weights and the allocation can follow the
observed rates without rebuilding anything.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.common import ArchSpec, CodingPlan as CodingCfg, \
    ShapeCfg
from repro_torch.core import coding, prng
from repro_torch.core.cocoef import (SCHEDULES, CocoEFConfig, FrameSums,
                                     check_mode,
                                     cocoef_update, group_buffers,
                                     group_cocoef_update, payload_specs)
from repro_torch.core.coding_state import CodingPlan, CodingState, \
    maybe_replan
from repro_torch.core.plan import PlanSpec
from repro_torch.data import pipeline
from repro_torch.kernels import ref
from repro_torch.nn.models import Model
from repro_torch.obs.metrics import reduce_frame
from repro_torch.optim.optimizers import (OptimizerConfig, apply_update,
                                          init_opt_state, lr_schedule)
from repro_torch.sim import stragglers

__all__ = ["TrainRun", "TrainSetup", "build_train_setup",
           "setup_encode_weights", "elastic_coding_state", "batch_stream"]

# the fields a plan carries; with TrainRun(plan=...) they stay at these
_PLAN_ALIASES = {"compressor": None, "k_budgets": None, "num_buckets": 1,
                 "bucket_schedule": "pipelined"}


@dataclasses.dataclass(frozen=True)
class TrainRun:
    """The knobs of one run (JAX's `TrainRun`, as far as it is ported).

    mode: "cocoef" (the paper's method), "coco" (its baseline without
      error feedback) or "dense" (stochastic gradient coding, no
      compression).
    base_lr / schedule / warmup / schedule_total: the learning rate
      gamma(step) (`optim.lr_schedule`: "constant", the paper's, "rsqrt"
      or "cosine" over schedule_total steps).
    plan: the deployment (`core.plan.PlanSpec`: d, allocation, wire,
      buckets).  With a plan the alias fields compressor, k_budgets,
      num_buckets and bucket_schedule stay at their defaults; without one
      `resolve_plan` assembles the plan from them and spec.coding.
    compressor: overrides spec.coding.compressor ("sign" | "block_topk" |
      "topk" | "identity").
    k_budgets: one block top-K budget per coding rank; overrides
      spec.coding.k_per_block and needs the block_topk wire.
    num_buckets / bucket_schedule: buckets of the flat vector and their
      issue order ("pipelined" | "serial", the same bits).
    phase2_dtype / phase2_sign: the broadcast of the aggregate ("float32"
      is the paper's; "bfloat16"; or re-packed on the sign wire).
    straggler / straggler_burst / straggler_spread / straggler_trace: the
      process of the masks (`sim.stragglers`: "iid", "markov" with its
      mean burst, "hetero" with p_i in p*(1 +/- spread), "trace" from a
      mask JSON or availability CSV).
    rate_aware: encode weights from the process's per-rank rates q_i
      (eq. 3 bit for bit under uniform rates); False = the mean-rate
      eq. 3 with spec.coding.straggler_p.
    elastic: the live coding plane: the step takes a `CodingState` and
      gathers each example's weight from its W, so rate estimates can move
      the weights (and, past replan_threshold, the allocation) every step.
    seed: the seed of the parameters (unless `init_state` is given a
      key), the batches and the masks (JAX's `PRNGKey(seed)`).
    prefetch: batches `batch_stream` stages ahead on a host thread (0:
      each made when pulled; the same bits either way).
    param_dtype: overrides the config's parameter dtype (JAX's: None keeps
      it; "bfloat16" stores theta and its gradient in bf16, the flat
      gradient read widened, the update computed in f32 and rounded once).
    ef_dtype: the error vectors' storage dtype ("float32" or "bfloat16":
      e' computed in f32 and rounded once, JAX's cast).  ghat and the
      optimizer state stay f32 either way.
    metrics: the step also returns metrics["telemetry"], the reduced
      `obs.MetricsFrame` (participation, per-rank wire bytes, gradient,
      error, compression and update norms), from chunked passes around
      each rank's local step; False runs the step exactly as without it.
    The MoE aux loss's weight is `nn.transformer.AUX_WEIGHT` (0.01), as
    in JAX, where `Model.loss` calls `weighted_loss` at its default."""

    base_lr: float = 1e-3
    schedule: str = "constant"
    schedule_total: Optional[int] = None
    warmup: int = 0
    optimizer: OptimizerConfig = OptimizerConfig()
    plan: Optional[PlanSpec] = None
    seed: int = 0
    compressor: Optional[str] = None
    k_budgets: Optional[Tuple[int, ...]] = None
    mode: str = "cocoef"
    phase2_dtype: str = "float32"
    phase2_sign: bool = False
    num_buckets: int = 1
    bucket_schedule: str = "pipelined"
    straggler: str = "iid"
    straggler_burst: float = 8.0
    straggler_spread: float = 0.5
    straggler_trace: Optional[str] = None
    rate_aware: bool = True
    elastic: bool = False
    replan_threshold: float = 0.1
    prefetch: int = 0
    metrics: bool = False
    ef_dtype: str = "float32"
    param_dtype: Optional[str] = None

    def __post_init__(self):
        check_mode(self.mode)
        ref.wire_dtype(self.ef_dtype)
        if self.param_dtype is not None:
            ref.wire_dtype(self.param_dtype)
        lr_schedule(self.schedule, self.base_lr, self.warmup,
                    self.schedule_total)
        if self.straggler not in stragglers.STRAGGLER_PROCESSES:
            raise ValueError(
                f"unknown straggler process {self.straggler!r}; "
                f"have {stragglers.STRAGGLER_PROCESSES}")
        if self.straggler_burst < 1.0:
            raise ValueError(f"straggler_burst={self.straggler_burst} must "
                             f"be >= 1 step")
        if self.straggler_spread < 0.0:
            raise ValueError(f"straggler_spread={self.straggler_spread} "
                             f"must be >= 0")
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
        if self.plan is not None:
            clash = [f for f, dflt in _PLAN_ALIASES.items()
                     if getattr(self, f) != dflt]
            if clash:
                raise ValueError(
                    f"TrainRun(plan=...) conflicts with deprecated alias "
                    f"field(s) {clash}: the plan already carries those "
                    f"knobs — set them on the PlanSpec instead")
        if not self.replan_threshold > 0.0:
            raise ValueError(f"replan_threshold={self.replan_threshold} "
                             f"must be > 0")
        if self.prefetch < 0:
            raise ValueError(f"prefetch={self.prefetch} must be >= 0")

    def resolve_plan(self, coding_cfg: CodingCfg, n_code: int) -> PlanSpec:
        """The run's PlanSpec on `n_code` coding ranks: `plan` with its
        num_ranks bound (or checked), or the plan the alias fields and
        `coding_cfg` imply (JAX `TrainRun.resolve_plan`)."""
        m = max(n_code, 1)
        if self.plan is not None:
            if self.plan.num_ranks is None:
                return dataclasses.replace(self.plan, num_ranks=m)
            if self.plan.num_ranks != m:
                raise ValueError(
                    f"plan targets num_ranks={self.plan.num_ranks} coding "
                    f"ranks but the mesh has {m}")
            return self.plan
        comp = self.compressor or coding_cfg.compressor
        k_per_block = coding_cfg.k_per_block
        if self.k_budgets is not None:
            if comp != "block_topk":
                raise ValueError(
                    f"k_budgets rides the block-top-K sparse wire; the "
                    f"effective compressor is {comp!r} (pass "
                    f"compressor='block_topk' or drop k_budgets)")
            if len(self.k_budgets) != m:
                raise ValueError(f"k_budgets has {len(self.k_budgets)} "
                                 f"entries, the run has {m} coding ranks")
            k_per_block = tuple(self.k_budgets)
        return PlanSpec(
            d=min(coding_cfg.redundancy, m), allocation="uniform",
            compressor=comp, group_size=coding_cfg.group_size,
            k_per_block=k_per_block, block_size=coding_cfg.block_size,
            topk_k=coding_cfg.topk_k, value_dtype=coding_cfg.wire_dtype,
            num_buckets=self.num_buckets,
            bucket_schedule=self.bucket_schedule, num_ranks=m)

    def coding_config(self, coding_cfg: CodingCfg, n_code: int
                      ) -> CocoEFConfig:
        """The wire this run codes with on `n_code` ranks: its resolved
        plan's, in this run's mode and phase 2."""
        plan = self.resolve_plan(coding_cfg, n_code)
        return CocoEFConfig(group_size=plan.group_size, mode=self.mode,
                            compressor=plan.compressor, topk_k=plan.topk_k,
                            k_per_block=plan.k_per_block,
                            block_size=plan.block_size,
                            wire_dtype=plan.value_dtype,
                            ef_dtype=self.ef_dtype,
                            phase2_dtype=self.phase2_dtype,
                            phase2_sign=self.phase2_sign,
                            num_buckets=plan.num_buckets,
                            bucket_schedule=plan.bucket_schedule)


# the inputs, weights (R, b) and, in elastic runs, subset ids (R, b) int64
# on the CPU; the inputs are tokens (R, b, S+1), or for the embeddings
# input embeddings (R, b, S, d) bf16 and targets (R, b, S)
Batch = Tuple[torch.Tensor, ...]


@dataclasses.dataclass
class TrainSetup:
    """Everything one run needs: the model over flat buffers, the coding
    plane, the payload buffers and the optimizer state, on one device.
    With a coding grid (`grid`) it is one coding rank's: `payload` is
    empty and `buffers` holds its (send, receive) buffers per bucket."""

    run: TrainRun
    model: Model
    n_code: int
    b_loc: int
    per_subset: int
    seq_len: int
    allocation: coding.Allocation    # the static (epoch-0) placement
    W: np.ndarray                    # (N, M) f32 static encode weights
    cocoef_cfg: CocoEFConfig
    straggler_process: Optional[stragglers.StragglerProcess]
    payload: Tuple[torch.Tensor, ...]     # the wire's, stacked over ranks
    opt_state: Tuple[torch.Tensor, ...]
    plan: Optional[PlanSpec] = None       # the resolved deployment plan
    straggler_rates: Optional[Tuple[float, ...]] = None   # rate-aware q_i
    coding_plan: Optional[CodingPlan] = None   # elastic runs: its current
    #   allocation is the one the batch maker uses
    grid: Optional[object] = None         # launch.mesh.CodingGrid
    buffers: Optional[List] = None        # group_buffers, with a grid
    embeddings: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False)         # the embeddings input, made once
    ghat: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False)         # (n,) f32 ghat buffer, when the
    #   gradient buffer cannot hold ghat (bf16 parameters)

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

    def init_state(self, key=None) -> Optional[torch.Tensor]:
        """theta = JAX's `init_params(key)` bit for bit (`Model.init_`;
        key defaults to PRNGKey(run.seed); JAX's driver passes
        PRNGKey(0)); returns the zero error vectors of its ranks ((N, n),
        or (n,) with a grid) in run.ef_dtype, or None in the coco and
        dense modes, which never read them (42.6 GB in f32 at the slice's
        n)."""
        self.model.init_(prng.PRNGKey(self.run.seed) if key is None
                         else key)
        if self.cocoef_cfg.mode != "cocoef":
            return None
        lead = () if self.grid is not None else (self.n_code,)
        return torch.zeros(lead + (self.flat_pad,),
                           dtype=ref.wire_dtype(self.run.ef_dtype),
                           device=self.device)

    @property
    def n_inputs(self) -> int:
        """The batch's leading input tensors: tokens, or embeddings and
        targets."""
        return 1 if self.model.cfg.input_mode == "tokens" else 2

    def make_batch(self, step: int) -> Batch:
        """The batch of this setup's R ranks (`ranks`) on the setup's
        device: tokens (R, b_loc, L+1), or embeddings (R, b_loc, L, d) bf16
        and targets (R, b_loc, L), then weights (R, b_loc); an elastic
        setup's weights are 1 and its batch adds the subset ids (R, b_loc)
        on the CPU, drawn from the coding plan's current allocation."""
        return self.batch_to_device(self.host_batch(step))

    def host_batch(self, step: int) -> Batch:
        """`make_batch`'s batch with every tensor still on the CPU (JAX's
        `make_batch_for_step`).  The embeddings input is JAX's
        normal(PRNGKey(seed), (N, b_loc, L, d), bf16) * 0.02, the same at
        every step, and its targets the coded tokens' first L."""
        vocab = self.model.cfg.vocab_size
        if self.coding_plan is not None:
            batch = pipeline.elastic_train_batch(
                self.run.seed, step, self.coding_plan.allocation,
                self.per_subset, self.seq_len, vocab, ranks=self.ranks)
        else:
            batch = pipeline.coded_train_batch(
                self.run.seed, step, self.allocation, self.W,
                self.per_subset, self.seq_len, vocab, ranks=self.ranks)
        if self.n_inputs == 1:
            return batch
        if self.embeddings is None:
            shape = (self.n_code, self.b_loc, self.seq_len,
                     self.model.cfg.d_model)
            emb = prng.normal_bf16(prng.PRNGKey(self.run.seed), shape) * \
                torch.tensor(0.02, dtype=torch.bfloat16)
            self.embeddings = emb[self.ranks]
        return (self.embeddings, batch[0][..., :-1]) + tuple(batch[1:])

    def batch_to_device(self, batch: Batch, device=None) -> Batch:
        """The inputs and weights to the setup's device (pinned and
        non-blocking on a card); subset ids stay on the CPU."""
        dev = self.device if device is None else torch.device(device)
        k = self.n_inputs + 1
        return pipeline.to_device(tuple(batch[:k]), dev) + tuple(batch[k:])

    def mask(self, step: int) -> torch.Tensor:
        if self.straggler_process is None:
            return torch.ones(self.n_code, dtype=torch.float32)
        return self.straggler_process.mask(self.run.seed, step)

    def batch_weights(self, batch: Batch,
                      coding_state: Optional[CodingState] = None
                      ) -> torch.Tensor:
        """The per-example weights stage 1 uses: the static batch's, or on
        an elastic batch W_scaled[rank, subset_id] from `coding_state`
        (`elastic_coding_state`), gathered on the host in f32 (JAX's
        `take_along_axis`; the ones multiply exactly)."""
        w = self.n_inputs
        if (len(batch) == w + 2) != (coding_state is not None):
            raise ValueError("an elastic setup's batch needs a coding_state "
                             "and a static one takes none")
        if coding_state is None:
            return batch[w]
        rows = np.asarray(self.ranks)[:, None]
        coef = np.asarray(coding_state.W, np.float32)[rows,
                                                      batch[w + 1].numpy()]
        return batch[w] * torch.from_numpy(coef).to(batch[w].device)

    def train_step(self, params: Model, e: Optional[torch.Tensor],
                   batch: Batch, step: int,
                   masks: Optional[torch.Tensor] = None,
                   kernel_spans: Optional[List] = None,
                   coding_state: Optional[CodingState] = None
                   ) -> Dict[str, torch.Tensor]:
        """One COCO-EF step (or COCO or SGC step, in the coco and dense
        modes); updates params.theta, e (only in cocoef mode; None is fine
        in the others) and the optimizer state in place.  masks: (N,)
        participation for this step (default: the setup's straggler
        process at `step`).  kernel_spans: see `cocoef_update`.
        coding_state: the elastic step's live encode weights (needed with
        an elastic batch).  With a grid, batch and e are this rank's.
        Returns {"loss": mean loss of the setup's ranks, "losses": (R,),
        "mask": (N,), "weights": (R, b_loc) the per-example weights}, with
        run.metrics "telemetry" (`obs.metrics.reduce_frame`), and in the
        MoE family "moe_dropped": (R,) int64, each rank's assignments the
        MoE layers dropped (over capacity), summed over the layers."""
        inputs = batch[:self.n_inputs]
        weights = self.batch_weights(batch, coding_state)
        mask = (self.mask(step) if masks is None else
                torch.as_tensor(masks, dtype=torch.float32))
        mask = mask.to(self.device).contiguous()
        losses, dropped = [], []

        def grad_of(i: int) -> torch.Tensor:
            params.grad.zero_()
            xs = [x[i] for x in inputs]
            loss, _ = params.loss(xs[0], weights[i], *xs[1:])
            loss.backward()
            losses.append(loss.detach())
            if params.net.moe_dropped is not None:
                dropped.append(params.net.moe_dropped)
            return params.grad

        frames: List = []
        self.coded_update(params, grad_of, e, mask, step, kernel_spans,
                          frames if self.run.metrics else None)
        ls = torch.stack(losses)
        out = {"loss": ls.mean(), "losses": ls, "mask": mask,
               "weights": weights}
        if frames:
            out["telemetry"] = reduce_frame(frames[0])
        if dropped:
            out["moe_dropped"] = torch.stack(dropped)
        return out

    def coded_update(self, params: Model, grad_of,
                     e: Optional[torch.Tensor], mask: torch.Tensor, step: int,
                     kernel_spans: Optional[List] = None,
                     frames: Optional[List] = None) -> torch.Tensor:
        """Stage 2 and the server update of one step: `cocoef_update` over
        the ranks' gradients grad_of(i) (with a grid `group_cocoef_update`
        on grad_of(0), this rank's), with ghat written into params.grad
        (on one device, on the dense wire and in dense mode ghat is the
        accumulator, payload[0]; with bf16 parameters the f32 `ghat`
        buffer), then theta <- theta - ghat in place.
        mask: (N,) f32 on the setup's device.  frames: a list that gets
        the step's `MetricsFrame` (`FrameSums` around each rank's local
        step, apply_update's norms); None takes no frame.  Returns ghat."""
        r = self.run
        gamma = lr_schedule(r.schedule, r.base_lr, r.warmup,
                            r.schedule_total)(step)
        # one copy to the device per step, made before stage 1 is queued,
        # instead of one per rank that would block the host between ranks
        gamma_dev = gamma.to(self.device)
        sums = None
        if frames is not None:
            sums = FrameSums(self.cocoef_cfg, mask, gamma_dev, self.ranks,
                             self.n_code if self.grid is None
                             else self.grid.nd, self.flat_pad)
        out = params.grad if self.ghat is None else self.ghat
        if self.grid is not None:
            ghat = group_cocoef_update(grad_of(0), e, mask, gamma_dev,
                                       self.cocoef_cfg, self.grid,
                                       self.buffers, out=out,
                                       kernel_spans=kernel_spans,
                                       metrics=sums)
        else:
            ghat = cocoef_update(grad_of, e, mask, gamma_dev,
                                 self.cocoef_cfg, self.payload,
                                 out=out, kernel_spans=kernel_spans,
                                 metrics=sums)
        res = apply_update(self.run.optimizer, params.theta, ghat,
                           self.opt_state, step, gamma,
                           want_norms=sums is not None)
        if sums is not None:
            frames.append(sums.frame.replace(**res[2]))
        return ghat


def build_train_setup(spec: ArchSpec, shape: ShapeCfg,
                      run: TrainRun = TrainRun(), smoke: bool = False,
                      n_code: int = 4, device="cuda",
                      group=None) -> TrainSetup:
    """The counterpart of JAX's `build_train_setup` on a (data=n_code,
    model=1) mesh.  The run's plan (`TrainRun.resolve_plan`) fixes d and
    the wire; M = n_code subsets; the straggler process is built unless
    it is iid with p = 0 (all ranks answer).  The allocation is cyclic
    (plan.allocation "uniform"), or `rate_aware_allocation` from the
    process's rates ("rate_aware", or "exact_load" with the same load on
    every rank); the encode weights are rate-aware (eq. 3 for uniform
    rates) or, with run.rate_aware False, the mean-rate eq. 3.  An elastic
    run also gets a `CodingPlan` over that allocation (re-allocating with
    exact loads unless the plan says "rate_aware").  The flat size is
    padded to nd * pad_multiple * num_buckets (nd the chunk ranks, n_code
    on one device); with compressor "topk" the wire is one block of
    n / nd per chunk and bucket, as on JAX's mesh.
    group: a `launch.mesh.CodingGrid`; this process is then its coding
    rank only, and n_code must be the grid's size.
    run.param_dtype, when set, replaces the config's (JAX's
    `dataclasses.replace(cfg, param_dtype=...)`); with bf16 parameters
    ghat gets an f32 buffer of its own (`TrainSetup.ghat`)."""
    cfg = spec.smoke if smoke else spec.config
    if run.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=run.param_dtype)
    if group is not None and n_code != group.size:
        raise ValueError(f"n_code={n_code}, the coding grid has "
                         f"{group.size} ranks")
    if n_code < 2:
        raise ValueError("the coded step needs at least 2 coding ranks")
    p = spec.coding.straggler_p
    plan = run.resolve_plan(spec.coding, n_code)
    proc = None
    if run.straggler != "iid" or p > 0:
        proc = stragglers.get_straggler_process(
            run.straggler, n_code, p, mean_burst=run.straggler_burst,
            spread=run.straggler_spread, trace=run.straggler_trace)
    rates = (tuple(float(x) for x in proc.rates())
             if run.rate_aware and proc is not None else None)
    M, d = n_code, plan.d
    q = (np.asarray(rates, np.float64) if rates is not None
         else np.full((n_code,), 1.0 - p))
    if plan.allocation == "uniform":
        alloc = coding.cyclic_allocation(n_code, M, d)
    else:
        alloc = coding.rate_aware_allocation(
            q, M, d, exact_load=(plan.allocation == "exact_load"))
    coding_plan = None
    if run.elastic:
        coding_plan = CodingPlan.create(
            q, M, d, drift_threshold=run.replan_threshold,
            exact_load=(plan.allocation != "rate_aware"), allocation=alloc)
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
    ghat = None
    if model.grad.dtype != torch.float32 and (group is not None
                                              or not ccfg.folds):
        ghat = torch.empty(n, dtype=torch.float32, device=dev)
    return TrainSetup(
        run=run, model=model, n_code=n_code, b_loc=per_subset * d,
        per_subset=per_subset, seq_len=shape.seq_len, allocation=alloc,
        W=(coding.encode_weights(alloc, rates=rates) if rates is not None
           else coding.encode_weights(alloc, p)), cocoef_cfg=ccfg,
        straggler_process=proc, payload=payload,
        opt_state=init_opt_state(run.optimizer, n, dev), plan=plan,
        straggler_rates=rates, coding_plan=coding_plan,
        grid=group, buffers=buffers, ghat=ghat)


def setup_encode_weights(setup: TrainSetup) -> np.ndarray:
    """The (N, M) f32 encode weights the setup aggregates with: rate-aware
    (per-rank q_i) when the setup carries straggler rates, else the
    mean-rate eq. 3 (JAX `setup_encode_weights`); built once, as setup.W."""
    return setup.W


def elastic_coding_state(setup: TrainSetup, rates=None
                         ) -> Tuple[CodingState, dict]:
    """One control tick of the elastic loop: `maybe_replan` on the latest
    estimates (None keeps the planned rates), then the batch maker's
    1/per_subset fold on the host in f32 (the static batch's division).
    Returns (CodingState for `train_step`, the replan info)."""
    if setup.coding_plan is None:
        raise ValueError("setup was built without TrainRun.elastic")
    st, info = maybe_replan(setup.coding_plan, rates)
    return st._replace(W=np.asarray(st.W) / setup.per_subset), info


def batch_stream(setup: TrainSetup, start_step: int = 0, prefetch: int = 0
                 ) -> Iterator[Batch]:
    """`make_batch` of steps start_step, start_step+1, ... on the setup's
    device.  prefetch=0 makes each batch when it is pulled; prefetch >= 1
    stages that many ahead on a host thread (`pipeline.prefetch_to_device`:
    pinned buffers, non-blocking copies on a side stream).  Batches are a
    function of (seed, step) and, in an elastic run, of the coding plan's
    allocation: a staged elastic batch made before a re-allocation (its
    epoch is older than the plan's at the pull) is made again on the
    spot, so a prefetched run trains on the bits a synchronous one does.
    The returned iterator has `close()` (and, prefetched, `.stats`)."""
    return _BatchStream(setup, start_step, prefetch)


class _BatchStream:
    def __init__(self, setup: TrainSetup, start_step: int, prefetch: int):
        if prefetch < 0:
            raise ValueError(f"prefetch={prefetch} must be >= 0")
        self.setup, self.step = setup, start_step
        self._pf = None
        if prefetch:
            self._pf = pipeline.prefetch_to_device(
                self._host(start_step), size=prefetch, device=setup.device,
                put=self._put)

    @property
    def stats(self) -> Optional[pipeline.PrefetchStats]:
        return self._pf.stats if self._pf is not None else None

    def _epoch(self) -> int:
        plan = self.setup.coding_plan
        return -1 if plan is None else plan.epoch

    def _host(self, t: int):
        while True:
            epoch = self._epoch()
            yield t, epoch, self.setup.host_batch(t)
            t += 1

    def _put(self, item, device):
        t, epoch, batch = item
        return t, epoch, self.setup.batch_to_device(batch, device)

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        t = self.step
        self.step += 1
        if self._pf is None:
            return self.setup.make_batch(t)
        made_at, epoch, batch = next(self._pf)
        assert made_at == t, (made_at, t)
        if epoch != self._epoch():          # re-allocated since: remake
            batch = self.setup.make_batch(t)
        return batch

    def close(self) -> None:
        if self._pf is not None:
            self._pf.close()


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
