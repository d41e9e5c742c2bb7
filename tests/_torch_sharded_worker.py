"""One rank of the sharded-step checks in tests/test_torch_sharded.py.

Run as ``python tests/_torch_sharded_worker.py RANK WORLD STORE IN OUT``
with ``PYTHONPATH=src``, one process a rank: joins a gloo group through
the file store STORE (every collective bounded by a timeout), lays the
(2, 2) mesh of ``MESH`` over it, and runs the port's sharded step there:
for each model of ``MODELS`` (parameters from IN, an npz of the
reference's, ``<model>/<path>`` keys) three train steps under each
placement policy, a prefill, and ``DECODE_STEPS`` decode steps with the
(float32, as the port's own decode-vs-forward test keeps it) cache
placed by ``cache_shardings``; then the dry run's cells of
``TRACED`` (``traced_cell``), rank 0's real step under the dry run's
counters. Rank 0 writes the whole results to OUT (npz). Imports torch
and the port only.
"""
import dataclasses
import sys

import numpy as np
import torch

N_RANKS = 4
TIMEOUT = 120.0                 # seconds, every collective of the group
MESH = (("data", "model"), (2, 2))
MODELS = ("qwen3-1.7b", "recurrentgemma-2b", "rwkv6-7b")
POLICIES = ("first_touch", "interleave")
TP = 2
BATCH, SEQ, STEPS = 8, 16, 3
LR, WARMUP = 1e-3, 1
DECODE_STEPS = 4
TRACED = ("qwen3-1.7b", "recurrentgemma-2b")


def mesh_spec():
    from repro_torch.core.partitioning import MeshSpec
    names, sizes = MESH
    return MeshSpec(names, sizes, np.arange(int(np.prod(sizes))).reshape(
        sizes))


def run_config(name: str, policy: str):
    """The reference's own test config: reduced ``name`` at lr 1e-3,
    warmup 1, sequence parallel, ``policy``."""
    from repro_torch.configs.reduced import REDUCED
    from repro_torch.core import config
    return config.RunConfig(
        arch=REDUCED[name], shape=config.LM_SHAPES["train_4k"],
        train=config.TrainConfig(learning_rate=LR, warmup_steps=WARMUP),
        sharding=config.ShardingConfig(
            policy=config.PlacementPolicy(policy), sequence_parallel=True))


def batch(name: str, step: int):
    from repro_torch.configs.reduced import REDUCED
    from repro_torch.data.pipeline import synth_batch
    return synth_batch(REDUCED[name], BATCH, SEQ, step=step, seed=0)


def traced_cell(name: str):
    """(arch, shape, cfg) of a dry-run cell at the gloo mesh's size: the
    reduced config at the kernels' head dim, BATCH x SEQ, float32."""
    from repro_torch.configs.reduced import REDUCED
    from repro_torch.core.config import ShapeConfig, StepKind
    from repro_torch.launch import dryrun
    arch = dataclasses.replace(REDUCED[name], head_dim=64)
    shape = ShapeConfig("train_gloo", StepKind.TRAIN, SEQ, BATCH)
    cfg = dataclasses.replace(dryrun.cell_config(arch, shape),
                              param_dtype="float32")
    return arch, shape, cfg


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
    return x.detach().float().cpu().numpy()


def main(rank: int, world: int, store_path: str, in_path: str,
         out_path: str) -> None:
    import torch.distributed as dist

    from repro_torch.core import dist as tdist
    from repro_torch.core.config import StepKind
    from repro_torch.core.params import from_reference
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding_plan as plan
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_train_step

    torch.manual_seed(0)
    arrays = dict(np.load(in_path))
    spec = mesh_spec()
    out = {}
    with tdist.process_group("gloo", rank=rank, world_size=world,
                             store=dist.FileStore(store_path, world),
                             timeout=TIMEOUT):
        dm = device_mesh(spec, "cpu")
        for name in MODELS:
            ref = unflat({k.split("|", 1)[1]: v for k, v in arrays.items()
                          if k.startswith(name + "|")})
            model = LMModel(run_config(name, "interleave").arch, tp=TP,
                            sequence_parallel=True,
                            cache_dtype=torch.float32, device="cpu")
            for policy in POLICIES:
                cfg = run_config(name, policy)
                params = from_reference(ref, "cpu")
                opt = adamw.init(params, cfg.train)
                oshard = plan.opt_state_shardings(model, cfg, spec, params,
                                                  opt)
                params = plan.distribute(
                    params, plan.param_shardings(model, cfg, spec), dm)
                opt = plan.distribute(opt, oshard, dm)
                step_fn = make_train_step(model, cfg, total_steps=STEPS)
                for s in range(STEPS):
                    b = {k: torch.from_numpy(v)
                         for k, v in batch(name, s).items()}
                    params, opt, m = step_fn(params, opt, b, s)
                    for k in ("loss", "grad_norm"):
                        out[f"{name}|{policy}|{k}{s}"] = _np(m[k])
                for k, v in flat(plan.gather(params)).items():
                    out[f"{name}|{policy}|param|{k}"] = _np(v)
            # prefill and decode, with the cache placed by the plan
            cfg = run_config(name, "interleave")
            params = plan.distribute(from_reference(ref, "cpu"),
                                     plan.param_shardings(model, cfg, spec),
                                     dm)
            toks = torch.from_numpy(batch(name, 0)["tokens"])
            pshape = dataclasses.replace(cfg.shape, global_batch=BATCH,
                                         seq_len=SEQ)
            bsh = plan.batch_specs(cfg.arch, pshape, spec)["shardings"]
            logits, _ = model.prefill(params, plan.distribute(
                {"tokens": toks}, {"tokens": bsh["tokens"]}, dm))
            out[f"{name}|prefill"] = _np(logits.full_tensor())
            cache = plan.distribute(
                model.init_cache(BATCH, SEQ),
                plan.cache_shardings(model, cfg, spec, BATCH, SEQ), dm)
            dsh = plan.batch_specs(cfg.arch, dataclasses.replace(
                pshape, kind=StepKind.DECODE), spec)["shardings"]["tokens"]
            for i in range(DECODE_STEPS):
                col = plan.distribute({"tokens": toks[:, i:i + 1]},
                                      {"tokens": dsh}, dm)
                logits, cache = model.decode_step(params, cache, col)
                out[f"{name}|decode{i}"] = _np(logits.full_tensor())
        # the dry run's cells, run for real: rank 0's counters
        for name in TRACED:
            arch, shape, cfg = traced_cell(name)
            model = LMModel(arch, tp=dryrun.model_tp(spec, cfg),
                            remat=cfg.train.remat, kernel_mode="ref",
                            sequence_parallel=True, device="cpu")
            params = model.init_params(0, torch.float32)
            opt = adamw.init(params, cfg.train)
            oshard = plan.opt_state_shardings(model, cfg, spec, params, opt)
            params = plan.distribute(
                params, plan.param_shardings(model, cfg, spec), dm)
            opt = plan.distribute(opt, oshard, dm)
            binfo = plan.batch_specs(arch, shape, spec)
            data = plan.distribute({k: torch.from_numpy(v) for k, v in
                                    batch(name, 0).items()},
                                   binfo["shardings"], dm)
            got = dryrun.trace(make_train_step(model, cfg),
                               (params, opt, data, 0), torch.device("cpu"))
            out[f"trace|{name}|step_peak_bytes"] = np.int64(
                got["step_peak_bytes"])
            out[f"trace|{name}|collectives"] = np.array(
                [(k, b, g) for k, b, g in got["collective_records"]],
                dtype=object).astype(str)
    if rank == 0:
        np.savez(out_path, **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
