"""The single-view regressor's training: ``train/trainer.py::make_train_step``
(the model in train mode, the loss through the SMIL forward and the
projection, backward, ``PlainAdam``) fed by ``DeviceDataCache.batch`` with
seeded shuffles of the cache, one step after another. On several cards
each rank is one process with one card; the run's process is rank 0 and
starts the others (a rendezvous file under ``TMPDIR``); the step is the
trainer's data-parallel one (DDP, global-batch BatchNorm), each rank taking
its rows of every global batch from its own whole cache, and the ranks
agree each step over a gloo group whether the window has closed, as the
trainer's epoch loop agrees on its flags.

Parameters: ``batch`` (a rank's rows of a step), ``check_steps``,
``warmup_steps``, ``trace_steps``.

Set-up draws the samples and the weights, fills the cache, builds the
model, optimizer and step, takes the first ``check_steps`` steps (Adam's
first moment read after the first) and ``warmup_steps`` more, then hands
the same step to the window. The rate is the images of every step enqueued
in the window over the seconds until the card has finished them. After the
window rank 0 computes the reference's steps on the same global batches and
the training rule compares them."""

from __future__ import annotations

import dataclasses
import datetime
import gc
import itertools
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

from portbench import faults, harness, inputs, program, trace, work
from portbench.reference import regressor as ref_reg

TARGETS = ("global_rot", "joint_rot", "betas", "trans", "keypoints_2d", "kp_visibility")


def build_program(r: harness.Run, inp: dict, mesh=None):
    """(model, optimizer, step, cache) of the port's trainer on the inputs."""
    from smilify_tpu_torch.cli.train_regressor import make_singleview_apply_fn
    from smilify_tpu_torch.models.regressor import compute_batch_loss
    from smilify_tpu_torch.train import trainer

    cfg = r.config
    spec = program.spec(inp["mesh_np"], r.device)
    rcfg, model = program.regressor(cfg, inp["weights"], r.device)
    model.train()
    res = cfg["image_size"]

    def loss_fn(preds, batch):
        return compute_batch_loss(spec, rcfg, preds, {k: batch[k] for k in TARGETS},
                                  cfg["loss_weights"], image_size=(res, res))

    opt = trainer.PlainAdam(model, cfg["lr"])
    step = trainer.make_train_step(model, make_singleview_apply_fn(rcfg, spec), loss_fn, opt,
                                   mesh=mesh)
    return model, opt, step, trainer.DeviceDataCache(inp["samples"], r.device)


def first_steps(model, opt, step, batches) -> dict:
    """Losses of the program's first steps, its first gradient's norm by
    parameter (Adam's first moment after one step over 1 − β1) and the
    change's norm by parameter."""
    named = dict(model.named_parameters())
    start = {k: v.detach().clone() for k, v in named.items()}
    losses, grad = [], {}
    for i, batch in enumerate(batches):
        loss, _ = step(batch)
        losses.append(float(loss))
        if i == 0:
            beta1 = opt.inner.param_groups[0]["betas"][0]
            for k, v in named.items():
                m = opt.inner.state.get(v, {}).get("exp_avg")
                grad[k] = 0.0 if m is None else float(torch.linalg.vector_norm(m)) / (1 - beta1)
    change = {k: float(torch.linalg.vector_norm(v.detach() - start[k])) for k, v in named.items()}
    return {"losses": losses, "grad": grad, "change": change}


def reference_steps(r: harness.Run, inp: dict, order, lower: bool = False) -> dict:
    """The reference's first steps on the same global batches; ``lower``
    computes them a precision lower: fp8 convolutions, TF32 matmuls."""
    cfg = r.config
    J, B = cfg["model"]["J"], cfg["model"]["B"]
    batches = [inp["samples"].batch(idx, r.device) for idx in order]
    conv = fp8_conv if lower else torch.nn.functional.conv2d
    harness.tf32(lower)
    try:
        losses, first, after = ref_reg.train_steps(
            inp["weights"], inp["m"], batches, cfg["head"], J, B, cfg["loss_weights"],
            cfg["image_size"], cfg["lr"], conv=conv)
    finally:
        harness.tf32(False)
    norm = lambda t: float(torch.linalg.vector_norm(t))  # noqa: E731
    return {"losses": losses, "grad": {k: norm(g) for k, g in first.items()},
            "change": {k: norm(after[k] - inp["weights"][k]) for k in first}}


def fp8(t):
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its max at 448)."""
    s = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return t + ((t / s).to(torch.float8_e4m3fn).to(t.dtype) * s - t).detach()


def fp8_conv(x, w, **kw):
    return torch.nn.functional.conv2d(fp8(x), fp8(w), **kw)


def run(r: harness.Run) -> harness.Outcome:
    world = r.cell["chips"]
    if world == 1:
        return rank_main(r)
    rendezvous = tempfile.mkdtemp(prefix="portbench_")
    store = os.path.join(rendezvous, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, daemon=True,
                         args=(dataclasses.replace(r, rank=i, world=world, store=store),))
             for i in range(1, world)]
    for proc in procs:
        proc.start()
    threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    try:
        out = rank_main(dataclasses.replace(r, rank=0, world=world, store=store))
    except BaseException:
        for proc in procs:
            proc.kill()
        raise
    finally:
        for proc in procs:
            proc.join(timeout=120)
            if proc.is_alive():
                proc.kill()
                proc.join()
        shutil.rmtree(rendezvous, ignore_errors=True)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return out


def _watch(procs) -> None:
    """End the run at once when a rank fails: rank 0 would otherwise wait
    in a collective until its timeout."""
    while True:
        time.sleep(1.0)
        failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
        if failed:
            print(f"portbench: a rank exited with {failed}; ending the run", file=sys.stderr,
                  flush=True)
            for p in procs:
                if p.is_alive():
                    p.kill()
            os._exit(1)
        if all(p.exitcode == 0 for p in procs):
            return


def _rank(r: harness.Run) -> None:
    try:
        rank_main(r)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def rank_main(r: harness.Run):
    """This rank's run; the outcome on rank 0, None elsewhere."""
    with harness.planted(r):
        return _rank_main(r)


def _rank_main(r: harness.Run):
    from smilify_tpu_torch.train import multihost, trainer

    cuda = torch.device(r.device).type == "cuda"
    if cuda:
        r = dataclasses.replace(r, device=f"cuda:{r.rank}")
    dev = torch.device(r.device)
    if cuda:
        torch.cuda.set_device(dev)
    harness.tf32(False)
    mesh = flags = None
    if r.world > 1:
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{r.store}",
                                rank=r.rank, world_size=r.world,
                                timeout=datetime.timedelta(seconds=180))
        mesh = trainer.data_mesh(dev)
        flags = multihost.host_group(multihost.axis_group(mesh, "data")[0])
    p, cfg = r.params, r.config
    gbatch = p["batch"] * r.world
    rows = trainer.rank_rows(gbatch, mesh) if mesh is not None else slice(None)
    inp = inputs.regressor_inputs(r.config, r.seed, r.device)
    model, opt, step, cache = build_program(r, inp, mesh)
    order = inputs.order_iter(cfg["cache_samples"], r.seed, gbatch)
    checked = list(itertools.islice(order, p["check_steps"]))
    prog = first_steps(model, opt, step, [cache.batch(idx[rows]) for idx in checked])
    for idx in itertools.islice(order, p["warmup_steps"]):
        step(cache.batch(idx[rows]))
    harness.sync(dev)
    if flags is not None:
        dist.barrier(group=flags)
    setup_s = time.perf_counter() - r.t0
    steps, seconds = 0, 0.0
    if not r.readings_only:
        t0 = time.perf_counter()
        deadline = t0 + r.seconds
        while True:
            step(cache.batch(next(order)[rows]))
            steps += 1
            if agree_closed(time.perf_counter() >= deadline, flags):
                break
        harness.sync(dev)
        seconds = time.perf_counter() - t0
    obs = {"chips": r.world, "window": {"seconds": seconds, "steps": steps,
                                        "items": steps * gbatch},
           "work": {"flops_per_item": 3 * image_flops(cfg), "peak_flops": work.PEAK_BF16}}
    if r.trace:
        def steps_of(n):
            rows_ = [next(order)[rows] for _ in range(n)]
            return lambda: [step(cache.batch(i)) for i in rows_]
        mine = trace.record(steps_of(p["trace_steps"]), dev, steps_of(2))
        obs["trace"] = dict(mine, steps=p["trace_steps"])
        if flags is not None:
            everyone = [None] * r.world
            dist.all_gather_object(everyone, mine["busy_s"], group=flags)
            obs["trace"]["busy_s"] = sum(everyone) / r.world
        obs["breakdown"] = trace.breakdown(mine)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if flags is not None:
        peaks = [None] * r.world
        dist.all_gather_object(peaks, peak, group=flags)
        peak = max(peaks)
    del model, opt, step, cache
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if r.world > 1:
        dist.destroy_process_group()
    if r.rank != 0:
        return None
    numbers = harness.training_numbers(prog, reference_steps(r, inp, checked))
    rate = {"train_images_per_s": steps * gbatch / seconds} if seconds else {}
    return harness.Outcome(numbers=numbers, rate=rate, setup_s=setup_s, attempted=steps,
                           failed=0, memory_peak_bytes=peak, count=r.world, obs=obs)


def agree_closed(mine: bool, flags) -> bool:
    """Whether any rank's window has closed (over the host group)."""
    if flags is None:
        return mine
    flag = torch.tensor([int(mine)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=flags)
    return bool(flag[0])


def image_flops(cfg: dict) -> float:
    m = cfg["model"]
    return work.regressor_image_flops(cfg["image_size"], cfg["head"], m["V_side"] ** 2, m["J"],
                                      m["B"])


def _unchanged():
    from smilify_tpu_torch.train import trainer as T

    def still(self):
        for q in self.params:
            q.grad = torch.zeros_like(q)
        self.inner.step()
    return faults.patched(T.PlainAdam, "step", still)


def _half_batch():
    from smilify_tpu_torch.train import trainer as T

    orig = T.make_train_step

    def halved(*args, **kw):
        step = orig(*args, **kw)
        return lambda batch: step({k: v[: len(v) // 2] for k, v in batch.items()})
    return faults.patched(T, "make_train_step", halved)


def _no_exchange():
    from smilify_tpu_torch.train import trainer as T

    return faults.patched(T, "data_parallel", lambda model, mesh: (model, None))


# faults.py: the gradients zeroed before Adam; the step on the first half of
# each batch; DDP and the global BatchNorm left out (on one card: nothing to leave)
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "no_exchange": _no_exchange}
