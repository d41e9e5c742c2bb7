"""One rank of the MoE and MLA sharded-step checks in
tests/test_torch_sharded_moe.py.

Run as ``python tests/_torch_sharded_moe_worker.py RANK WORLD STORE IN
OUT FAMILY`` with ``PYTHONPATH=src``, one process a rank: joins a gloo
group through the file store STORE (every collective bounded by a
timeout) and, for each case of ``CASES[FAMILY]``, lays its mesh over the
group and runs the port's sharded route there, parameters from IN (an npz
of the reference's, ``<case>|<path>`` keys): a forward (logits, aux), a
loss with every parameter's gradient, and, where nothing drops, DECODE_
STEPS decode steps with a float32 cache placed by ``cache_shardings``;
first, in a fresh process as the dry run's trace is, the dry run's cell
of the family (``traced_cell``), rank 0's real train step under the dry
run's counters. Rank 0 writes the whole
results to OUT (npz). Imports torch and the port only.
"""
import dataclasses
import sys

import numpy as np
import torch

N_RANKS = 4
TIMEOUT = 120.0                 # seconds, every collective of the group
BATCH, SEQ = 4, 32
DECODE_STEPS = 4
# case tag -> (model, (data, model) mesh, expert_parallel_data, experts,
# capacity factor). Factor 4.0 drops nothing; at 0.5 every owner takes 8
# of the 32 x 2 assignments each rank routes (the capacity's floor), so
# at least half of them drop. The phi3.5-moe cases hold 2 experts a rank,
# the deepseek-v3 ones 1.
CASES = {
    "phi3.5-moe": {
        "phi-1x4-cf4": ("phi3.5-moe", (1, 4), False, 8, 4.0),
        "phi-1x4-cf0.5": ("phi3.5-moe", (1, 4), False, 8, 0.5),
    },
    "deepseek-v3": {
        "ds-2x2-cf4": ("deepseek-v3", (2, 2), True, 4, 4.0),
        "ds-2x2-cf0.5": ("deepseek-v3", (2, 2), True, 4, 0.5),
    },
}
# the dry run's cell of each family: (mesh, batch, seq)
TRACED = {"phi3.5-moe": ((1, 4), 4, 16), "deepseek-v3": ((2, 2), 16, 16)}


def mesh_spec(sizes):
    from repro_torch.core.partitioning import MeshSpec
    return MeshSpec(("data", "model"), tuple(sizes),
                    np.arange(int(np.prod(sizes))).reshape(sizes))


def case_arch(tag, reduced=None):
    """The case's reduced config (from ``reduced``, the port's by default)
    and (mesh sizes, expert axes)."""
    if reduced is None:
        from repro_torch.configs.reduced import REDUCED as reduced
    family = tag_family(tag)
    name, sizes, epd, n_experts, cf = CASES[family][tag]
    arch = reduced[name]
    arch = dataclasses.replace(arch, moe=dataclasses.replace(
        arch.moe, n_experts=n_experts, capacity_factor=cf))
    return arch, sizes, (("data", "model") if epd else ("model",))


def tag_family(tag):
    return next(f for f, cases in CASES.items() if tag in cases)


def run_config(arch, sizes, expert_axes):
    from repro_torch.core import config
    return config.RunConfig(
        arch=arch, shape=config.LM_SHAPES["train_4k"],
        sharding=config.ShardingConfig(
            sequence_parallel=True,
            expert_parallel_data=len(expert_axes) > 1))


def batch(arch, step=0):
    from repro_torch.data.pipeline import synth_batch
    return synth_batch(arch, BATCH, SEQ, step=step, seed=0)


def traced_cell(family):
    """(arch, shape, cfg, mesh) of the family's dry-run cell: the reduced
    config, float32, the cell's accumulation (4 microbatches, 8 for
    deepseek-v3)."""
    from repro_torch.configs.reduced import REDUCED
    from repro_torch.core.config import ShapeConfig, StepKind
    from repro_torch.launch import dryrun
    sizes, b, s = TRACED[family]
    arch = REDUCED[family]
    shape = ShapeConfig("train_gloo", StepKind.TRAIN, s, b)
    cfg = dataclasses.replace(dryrun.cell_config(arch, shape),
                              param_dtype="float32")
    return arch, shape, cfg, mesh_spec(sizes)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def unflat(d):
    out = {}
    for path, v in d.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def _np(x):
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().float().cpu().numpy()


def loss_and_grads(model, params, b):
    """(loss, {path: gradient}) of ``model.loss_fn`` on DTensors (the
    backward's recomputed layers, too, under implicit replication)."""
    from repro_torch.kernels.common import replicating
    leaves = flat(params)
    paths = sorted(leaves)
    xs = {k: leaves[k].detach().requires_grad_() for k in paths}
    with replicating(params):
        loss, _ = model.loss_fn(unflat(xs), b)
        grads = torch.autograd.grad(loss, [xs[k] for k in paths])
    return loss, dict(zip(paths, grads))


def main(rank, world, store_path, in_path, out_path, family):
    import torch.distributed as dist

    from repro_torch.core import dist as tdist
    from repro_torch.core.config import StepKind
    from repro_torch.core.params import from_reference
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding_plan as plan
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_train_step

    torch.manual_seed(0)
    arrays = dict(np.load(in_path))
    out = {}
    with tdist.process_group("gloo", rank=rank, world_size=world,
                             store=dist.FileStore(store_path, world),
                             timeout=TIMEOUT):
        # the dry run's cell, run for real: rank 0's counters
        arch, shape, cfg, spec = traced_cell(family)
        dm = device_mesh(spec, "cpu")
        model = LMModel(arch, tp=dryrun.model_tp(spec, cfg),
                        remat=cfg.train.remat, kernel_mode="ref",
                        sequence_parallel=True, moe_mesh=dm,
                        expert_axes=(("data", "model")
                                     if cfg.sharding.expert_parallel_data
                                     else ("model",)), device="cpu")
        params = model.init_params(0, torch.float32)
        opt = adamw.init(params, cfg.train)
        oshard = plan.opt_state_shardings(model, cfg, spec, params, opt)
        params = plan.distribute(params, plan.param_shardings(model, cfg,
                                                              spec), dm)
        opt = plan.distribute(opt, oshard, dm)
        binfo = plan.batch_specs(arch, shape, spec)
        data = plan.distribute(
            {k: torch.from_numpy(v) for k, v in synth_batch(
                arch, shape.global_batch, shape.seq_len, step=0,
                seed=0).items()}, binfo["shardings"], dm)
        got = dryrun.trace(make_train_step(model, cfg),
                           (params, opt, data, 0), torch.device("cpu"))
        out["trace|step_peak_bytes"] = np.int64(got["step_peak_bytes"])
        out["trace|collectives"] = np.array(
            [(k, b, g) for k, b, g in got["collective_records"]],
            dtype=object).astype(str)
        for tag in CASES[family]:
            arch, sizes, axes = case_arch(tag)
            spec = mesh_spec(sizes)
            dm = device_mesh(spec, "cpu")
            cfg = run_config(arch, sizes, axes)
            model = LMModel(arch, tp=sizes[1], sequence_parallel=True,
                            moe_mesh=dm, expert_axes=axes,
                            cache_dtype=torch.float32, device="cpu")
            ref = unflat({k.split("|", 1)[1]: v for k, v in arrays.items()
                          if k.startswith(tag + "|")})
            params = plan.distribute(from_reference(ref, "cpu"),
                                     plan.param_shardings(model, cfg, spec),
                                     dm)
            b = {k: torch.from_numpy(v) for k, v in batch(arch).items()}
            bsh = plan.batch_specs(arch, dataclasses.replace(
                cfg.shape, global_batch=BATCH, seq_len=SEQ), spec,
            )["shardings"]
            db = plan.distribute(b, {k: bsh[k] for k in b}, dm)
            logits, _, aux = model.forward(params, {"tokens": db["tokens"]})
            out[f"{tag}|logits"], out[f"{tag}|aux"] = _np(logits), _np(aux)
            loss, grads = loss_and_grads(model, params, db)
            out[f"{tag}|loss"] = _np(loss)
            for k, g in grads.items():
                out[f"{tag}|grad|{k}"] = _np(g)
            if arch.moe.capacity_factor < 4.0:
                continue
            cache = plan.distribute(
                model.init_cache(BATCH, SEQ),
                plan.cache_shardings(model, cfg, spec, BATCH, SEQ), dm)
            dsh = plan.batch_specs(arch, dataclasses.replace(
                cfg.shape, kind=StepKind.DECODE, global_batch=BATCH,
                seq_len=SEQ), spec)["shardings"]["tokens"]
            for i in range(DECODE_STEPS):
                col = plan.distribute({"tokens": b["tokens"][:, i:i + 1]},
                                      {"tokens": dsh}, dm)
                logits, cache = model.decode_step(params, cache, col)
                out[f"{tag}|decode{i}"] = _np(logits)
    if rank == 0:
        np.savez(out_path, **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5], sys.argv[6])
