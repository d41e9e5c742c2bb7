"""The decoder LM stack, for every layer plan of ``repro.configs``.

The counterpart of ``repro.models.lm.LMModel``:
  dense  (yi-34b, qwen2-0.5b, qwen3-1.7b, granite-3-8b):  GQA + SwiGLU
  moe    (phi3.5-moe):         GQA + MoE (leading dense layers of their own
                               width and shared experts where configured)
  moe+mla (deepseek-v3):       MLA + MoE (3 leading dense layers, a shared
                               expert) + the MTP head
  hybrid (recurrentgemma-2b):  (RG-LRU, RG-LRU, local-attn) pattern + GeGLU
  ssm    (rwkv6-7b):           time-mix + channel-mix (attention-free)
  audio  (musicgen-large):     GQA over precomputed frame embeddings, one
                               head per codebook
  vlm    (qwen2-vl-2b):        GQA + M-RoPE over the [patch; text] stream

Parameters and caches keep the reference's layout (``core.params``): a
homogeneous stack is stacked along a leading layer axis (an MoE stack's
leading dense layers are ``dense_blocks``, its MoE layers ``blocks``) and
a pattern's tail is ``tail{i}``. Where the reference scans the stack, the
port walks it with a Python loop over views, one ``unbind(0)`` of each
stacked leaf a pass (indexing ``t[i]`` per layer would make the backward
write a full-size zero buffer for every layer of every leaf). With
``remat="block"`` each stacked layer, or each hybrid super-block, runs
under ``torch.utils.checkpoint`` when a gradient is being taken, as the
reference wraps its scan body; the tail is not wrapped, as in the
reference. ``prefill`` applies the head to the last position only.
``loss_fn`` is the reference's, the multi-token-prediction loss
included where the config has the MTP head (``params["mtp"]``: one more
dense layer over [norm(h_t); norm(embed(labels_t))]); ``forward`` sums the
MoE layers' aux losses. ``cache_axes`` gives each cache leaf's logical
axes, as the reference's.

``tp`` pads head counts, vocab and FFN widths as the reference pads them
for tensor parallelism over that many ranks (``PaddedDims.for_tp``), so
that the schema, and ``launch.sharding_plan``'s specs over it, are the
reference's. With ``moe_mesh`` each MoE layer of a full-sequence pass is
the reference's sequence-parallel ``shard_map`` dispatch, the shared
experts added outside it. On a ``core.vmesh.VirtualMesh`` of n shards the
tokens split into n sequence blocks, shard i takes block i and a view of
experts [i E/n, (i + 1) E/n), ``moe.moe_forward_sharded`` runs on the
mesh and the blocks are put back together. On DTensor parameters
``moe_mesh`` is their ``DeviceMesh`` and ``expert_axes`` the mesh axes the
experts split over (the reference's): with ``sequence_parallel`` the
normed stream enters the dispatch in ``sp_spec``, every token on one
rank, and ``moe.moe_forward_dtensor`` runs it on each rank's blocks.
Decode keeps the one-device dispatch, as the reference's (on DTensors
with the expert weights where they lie).

On DTensor parameters (the sharded step, ``launch.sharding_plan.
distribute``) the same code runs sharded: ``sequence_parallel`` and
``data_axes`` are the reference's, and its sharding constraints become
redistributions of the residual stream to the same placements, the
sequence-parallel ``sp_spec`` P(dp, "model", None) around every block and
``act_spec`` P(dp, None, None) after the embedding; on plain tensors they
do nothing. Where the reference leaves GSPMD to gather the split stream
for a block's products, the port gathers each normed stream to
``act_spec`` itself (``mix_spec``). The entry points run under DTensor's
implicit replication, so that the positions, masks and scalars each rank
makes stand for replicated tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import (ArchConfig, AttentionKind, PaddedDims,
                                     RopeKind, pad_to, resolve_device)
from repro_torch.core.params import ParamDef, init_params, pdef
from repro_torch.core.partitioning import MeshSpec, P, placements
from repro_torch.core.vmesh import VirtualMesh
from repro_torch.kernels.common import is_sharded, replicating
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import cross_entropy, rms_norm, swiglu

REMAT = ("none", "block")


def _stack_schema(schema: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Prepend a stacked 'layers' dimension to every ParamDef."""
    out = {}
    for k, v in schema.items():
        if isinstance(v, ParamDef):
            out[k] = pdef((n,) + v.shape, ("layers",) + v.axes, v.init,
                          v.scale, v.dtype)
        else:
            out[k] = _stack_schema(v, n)
    return out


def _unstack(tree: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The ``n`` layers of a stacked tree, as views: one ``unbind(0)`` of
    each leaf, whose backward stacks the layers' grads once."""
    layers: List[Dict[str, Any]] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = v.unbind(0) if isinstance(v, torch.Tensor) else _unstack(v, n)
        for layer, part in zip(layers, parts):
            layer[k] = part
    return layers


def _restack(per_layer: List[Dict[str, torch.Tensor]],
             views: List[Dict[str, torch.Tensor]],
             stacked: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The stacked cache after one decode step: a buffer every layer wrote
    in place is kept as it is, new per-layer states are stacked anew."""
    out = {}
    for name, buf in stacked.items():
        if all(c[name] is v[name] for c, v in zip(per_layer, views)):
            out[name] = buf
        else:
            out[name] = torch.stack([c[name] for c in per_layer])
    return out


def _mlp_schema(arch: ArchConfig, padded: PaddedDims,
                d_ff: Optional[int] = None) -> Dict[str, Any]:
    d = arch.d_model
    f = d_ff if d_ff is not None else padded.d_ff
    return {
        "w_gate": pdef((d, f), ("embed", "ff"), "scaled"),
        "w_up": pdef((d, f), ("embed", "ff"), "scaled"),
        "w_down": pdef((f, d), ("ff", "embed"), "scaled"),
    }


FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table``'s rows at ``ids``. A table split over its rows (the
    vocab over "model") goes through ``F.embedding``, whose DTensor rule
    looks up each rank's rows and sums the partial results (at once: an
    operator after it may not take them partial), where an index would
    gather the whole table on every rank; so do split ids (the batch over
    "data"), since PyTorch 2.11's DTensor rule for the index's backward
    fails on them. Otherwise an index, as on plain tensors."""
    from torch.distributed.tensor import Replicate
    if is_sharded(table) and any(p.is_shard() for t in (table, ids)
                                 if is_sharded(t) for p in t.placements):
        out = torch.nn.functional.embedding(ids.long(), table)
        return out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return table[ids.long()]


def _constrain(x: torch.Tensor, spec: Optional[P]) -> torch.Tensor:
    """The reference's sharding constraint: a DTensor redistributed to
    ``spec``'s placements on its own mesh (axes the mesh lacks left out);
    anything else as it is."""
    if spec is None or not is_sharded(x):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    mspec = MeshSpec(names, tuple(mesh.shape))

    def present(axis):
        if isinstance(axis, tuple):
            kept = tuple(a for a in axis if a in names)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return axis if axis in names else None
    want = placements(P(*(present(a) for a in spec)), mspec)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


class LMModel:
    """Schema + apply functions over a parameter tree; no owned state.

    ``device`` is where ``init_params`` and ``init_cache`` put their
    tensors: the CUDA device unless ``device="cpu"`` (raises without a
    GPU). ``kernel_mode`` is passed to the kernels' dispatch; ``remat``
    ("none" | "block") whether a pass that takes a gradient recomputes
    each stacked layer (super-block) in the backward."""

    def __init__(self, arch: ArchConfig, tp: int = 1, *,
                 sequence_parallel: bool = False,
                 data_axes: Tuple[str, ...] = ("data",),
                 kernel_mode: Optional[str] = None,
                 remat: str = "block",
                 moe_mesh=None, expert_axes: Tuple[str, ...] = ("model",),
                 cache_dtype: torch.dtype = torch.bfloat16,
                 device: Union[None, str, torch.device] = None):
        if arch.family not in FAMILIES:
            raise ValueError(f"{arch.name}: unknown family {arch.family!r}, "
                             f"not one of {FAMILIES}")
        if remat not in REMAT:
            raise ValueError(f"remat {remat!r} not in {REMAT}")
        self.arch = arch
        self.remat = remat
        self.tp = tp
        self.padded = PaddedDims.for_tp(arch, tp)
        self.moe_mesh = moe_mesh
        self.expert_axes = tuple(expert_axes)
        self.kernel_mode = kernel_mode
        self.cache_dtype = cache_dtype
        self.device = resolve_device(device)
        dp = (data_axes if len(data_axes) > 1
              else (data_axes[0] if data_axes else None))
        self.sp_spec = P(dp, "model", None) if sequence_parallel else None
        self.act_spec = P(dp, None, None)
        # under sequence parallelism the normed stream is gathered back to
        # whole sequences before a mixer or FFN (their products, the
        # token shifts and the scans need them), and a mixer's or FFN's
        # partial sums are scattered to the split residual before they
        # are added, so that their gradients come back whole: Megatron's
        # pattern, which GSPMD derives in the reference
        self.mix_spec = self.act_spec if sequence_parallel else None
        if arch.family == "hybrid":
            pat = arch.hybrid.pattern
            n_super = arch.n_layers // len(pat)
            tail = [pat[i % len(pat)]
                    for i in range(n_super * len(pat), arch.n_layers)]
            self.plan = {"kind": "hybrid", "n_super": n_super,
                         "pattern": tuple(pat), "tail": tail}
        elif arch.moe is not None:
            nd = arch.moe.n_dense_layers
            self.plan = {"kind": "moe", "n_dense": nd,
                         "n_moe": arch.n_layers - nd}
        else:
            self.plan = {"kind": "rwkv" if arch.family == "ssm" else "dense",
                         "n": arch.n_layers}

    def _groups(self) -> List[Tuple[str, str, int]]:
        """(tree key, layer kind, layers) of each homogeneous stack, in
        execution order, for every plan but the hybrid one."""
        plan = self.plan
        if plan["kind"] == "moe":
            dense = ([("dense_blocks", "dense", plan["n_dense"])]
                     if plan["n_dense"] else [])
            return dense + [("blocks", "moe", plan["n_moe"])]
        return [("blocks", plan["kind"], plan["n"])]

    # ------------------------------------------------------------------
    # schema and parameters
    # ------------------------------------------------------------------
    def _layer_schema(self, kind: str) -> Dict[str, Any]:
        arch = self.arch
        d = arch.d_model
        ln = lambda: pdef((d,), ("embed",), "ones")
        if kind == "rwkv":
            # the channel mix's parameters (cm_*) live inside "tm"
            return {"ln1": ln(), "tm": rwkv_mod.rwkv_schema(arch),
                    "ln2": ln()}
        if kind == "rglru":
            mix = {"rglru": rglru_mod.rglru_schema(arch)}
        elif arch.attention == AttentionKind.MLA:
            mix = {"attn": attn_mod.mla_schema(arch, self.padded)}
        else:
            mix = {"attn": attn_mod.gqa_schema(arch, self.padded)}
        if kind == "moe":
            return {"ln1": ln(), **mix, "ln2": ln(),
                    "moe": moe_mod.moe_schema(arch)}
        # an MoE stack's leading dense layers may have a width of their own
        d_ff = (pad_to(arch.moe.dense_d_ff, self.tp)
                if arch.moe is not None and arch.moe.dense_d_ff is not None
                else None)
        return {"ln1": ln(), **mix, "ln2": ln(),
                "mlp": _mlp_schema(arch, self.padded, d_ff)}

    def schema(self) -> Dict[str, Any]:
        arch, plan = self.arch, self.plan
        d, Vp = arch.d_model, self.padded.vocab_size
        s: Dict[str, Any] = {}
        if arch.n_codebooks:
            s["embed_codes"] = pdef((arch.n_codebooks, Vp, d),
                                    (None, "vocab", "embed"))
            s["head_codes"] = pdef((arch.n_codebooks, d, Vp),
                                   (None, "embed", "vocab"), "scaled")
        else:
            s["embed"] = pdef((Vp, d), ("vocab", "embed"))
            if not arch.tie_embeddings:
                s["lm_head"] = pdef((d, Vp), ("embed", "vocab"), "scaled")
        s["final_norm"] = pdef((d,), ("embed",), "ones")
        if plan["kind"] == "hybrid":
            s["blocks"] = _stack_schema(
                {f"sub{i}": self._layer_schema(k)
                 for i, k in enumerate(plan["pattern"])}, plan["n_super"])
            for i, k in enumerate(plan["tail"]):
                s[f"tail{i}"] = self._layer_schema(k)
        else:
            for key, kind, n in self._groups():
                s[key] = _stack_schema(self._layer_schema(kind), n)
        if arch.mtp:
            s["mtp"] = {
                "proj": pdef((2 * d, d), (None, "embed"), "scaled"),
                "norm_h": pdef((d,), ("embed",), "ones"),
                "norm_e": pdef((d,), ("embed",), "ones"),
                "layer": self._layer_schema("dense"),
            }
        return s

    def init_params(self, seed: int = 0,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Parameters drawn on the model's device from a generator seeded
        with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.schema(), gen, dtype, self.device)

    def _units(self, tree: Dict[str, Any]
               ) -> Iterator[Tuple[bool, List[Tuple[str, str, int,
                                                   Dict[str, Any]]]]]:
        """The layers of a parameter or cache tree in execution order, in
        units: (stacked, [(kind, key, layer index in the stack or -1,
        layer view)]). A unit is a super-block of the hybrid pattern or
        one layer of a homogeneous stack (stacked), or one tail layer."""
        plan = self.plan
        if plan["kind"] == "hybrid":
            pattern = list(enumerate(plan["pattern"]))
            subs = {f"sub{i}": _unstack(tree["blocks"][f"sub{i}"],
                                        plan["n_super"]) for i, _ in pattern}
            for s in range(plan["n_super"]):
                yield True, [(kind, f"sub{i}", s, subs[f"sub{i}"][s])
                             for i, kind in pattern]
            for i, kind in enumerate(plan["tail"]):
                yield False, [(kind, f"tail{i}", -1, tree[f"tail{i}"])]
        else:
            for key, kind, n in self._groups():
                for s, layer in enumerate(_unstack(tree[key], n)):
                    yield True, [(kind, key, s, layer)]

    def _walk(self, tree: Dict[str, Any]
              ) -> Iterator[Tuple[str, str, int, Dict[str, Any]]]:
        """(kind, key, layer index in the stack or -1, layer view) of every
        layer in execution order, for a parameter or cache tree."""
        for _, layers in self._units(tree):
            yield from layers

    # ------------------------------------------------------------------
    # full sequence
    # ------------------------------------------------------------------
    def _block_fwd(self, kind: str, p: Dict[str, Any], x: torch.Tensor,
                   positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the layer's output, its aux loss: 0 but for an MoE layer)."""
        arch = self.arch
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x = _constrain(x, self.sp_spec)
        h = _constrain(rms_norm(x, p["ln1"], arch.norm_eps), self.mix_spec)
        if kind == "rwkv":
            mix = rwkv_mod.time_mix_forward(p["tm"], h, arch,
                                            self.kernel_mode)
        elif kind == "rglru":
            mix = rglru_mod.rglru_forward(p["rglru"], h, arch,
                                          self.kernel_mode)
        elif arch.attention == AttentionKind.MLA:
            mix = attn_mod.mla_forward(p["attn"], h, arch,
                                       positions=positions,
                                       kernel_mode=self.kernel_mode)
        else:
            window = (arch.hybrid.window
                      if kind == "local_attn" and arch.hybrid else None)
            mix = attn_mod.gqa_forward(p["attn"], h, arch,
                                       positions=positions, window=window,
                                       kernel_mode=self.kernel_mode)
        x = _constrain(x + _constrain(mix, self.sp_spec), self.sp_spec)
        h = rms_norm(x, p["ln2"], arch.norm_eps)
        if kind == "moe":
            y, aux = self._moe(p["moe"], h)
            return _constrain(x + _constrain(y, self.sp_spec),
                              self.sp_spec), aux
        h = _constrain(h, self.mix_spec)
        if kind == "rwkv":
            y = rwkv_mod.channel_mix_forward(p["tm"], h)
        else:
            y = swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                       p["mlp"]["w_down"], arch.act)
        # the block's output too: the residual that remat keeps stays split
        return _constrain(x + _constrain(y, self.sp_spec), self.sp_spec), aux

    def _moe(self, p: Dict[str, Any], h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """An MoE layer's FFN on the normed stream ``h``: the sharded
        dispatch on ``moe_mesh`` (a virtual mesh; on DTensors with
        sequence parallelism, their ``DeviceMesh``), else the one-device
        one."""
        arch = self.arch
        if isinstance(self.moe_mesh, VirtualMesh):
            return self._moe_sharded(p, h)
        if self.moe_mesh is not None and not is_sharded(h):
            raise ValueError("moe_mesh is a DeviceMesh: the parameters "
                             "must be DTensors on it")
        if self.moe_mesh is None or self.sp_spec is None:
            return moe_mod.moe_forward(p, _constrain(h, self.mix_spec), arch)
        y, aux = moe_mod.moe_forward_dtensor(p, _constrain(h, self.sp_spec),
                                             arch, self.expert_axes)
        if arch.moe.n_shared_experts:
            y = y + _constrain(moe_mod.shared_expert_forward(
                p, _constrain(h, self.mix_spec), arch), self.sp_spec)
        return y, aux

    def _moe_sharded(self, p: Dict[str, Any], h: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``shard_map`` MoE on ``moe_mesh``: sequence
        block i and experts block i on shard i, the shared experts added
        outside."""
        arch, mesh = self.arch, self.moe_mesh
        n, S = mesh.n, h.shape[1]
        if S % n:
            raise ValueError(f"{S} positions do not split into {n} shards")
        el, sl = arch.moe.n_experts // n, S // n
        inputs = [({"router": p["router"],
                    **{k: p[k][i * el:(i + 1) * el]
                       for k in ("w_gate", "w_up", "w_down")}},
                   h[:, i * sl:(i + 1) * sl]) for i in range(n)]
        outs = mesh.run(lambda comm, a: moe_mod.moe_forward_sharded(
            comm, a[0], a[1], arch), inputs)
        y = torch.cat([o for o, _ in outs], dim=1)
        if arch.moe.n_shared_experts:
            y = y + moe_mod.shared_expert_forward(p, h, arch)
        return y, outs[0][1]

    def _embed(self, params: Dict[str, Any],
               batch: Dict[str, Any]) -> torch.Tensor:
        arch = self.arch
        if arch.n_codebooks:
            # the audio stub: precomputed frame embeddings (EnCodec's)
            return batch["embeds"]
        tok = _lookup(params["embed"], batch["tokens"])
        if arch.vlm and "patch_embeds" in batch:
            tok = torch.cat([batch["patch_embeds"].to(tok.dtype), tok],
                            dim=1)
        if arch.family == "hybrid":
            tok = tok * torch.tensor(arch.d_model ** 0.5, dtype=tok.dtype)
        return tok

    def _positions(self, batch: Dict[str, Any], seq_len: int,
                   device: torch.device) -> torch.Tensor:
        """(S,) positions, or (B, S, 3) (t, h, w) streams for M-RoPE: the
        patches' own, then the text's from the patch count on."""
        if self.arch.rope != RopeKind.MROPE:
            return torch.arange(seq_len, device=device)
        if "patch_pos" in batch:
            patch = batch["patch_pos"].long()
            B, P = patch.shape[:2]
            text = P + torch.arange(seq_len - P, device=device)
            return torch.cat([patch, text[None, :, None].expand(
                B, seq_len - P, 3)], dim=1)
        B = batch["tokens"].shape[0]
        return torch.arange(seq_len, device=device)[None, :, None].expand(
            B, seq_len, 3)

    def _head(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        x = _constrain(rms_norm(x, params["final_norm"], self.arch.norm_eps),
                       self.mix_spec)
        if self.arch.n_codebooks:
            return torch.einsum("bsd,cdv->bscv", x, params["head_codes"])
        if self.arch.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x, params["embed"])
        return torch.einsum("bsd,dv->bsv", x, params["lm_head"])

    def _unit_fwd(self, kinds: Tuple[str, ...], ps: List[Dict[str, Any]],
                  x: torch.Tensor, positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for kind, p in zip(kinds, ps):
            x, a = self._block_fwd(kind, p, x, positions)
            aux = aux + a
        return x, aux

    def _hidden(self, params: Dict[str, Any], batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the last layer's output, the layers' summed aux loss)."""
        x = _constrain(self._embed(params, batch), self.act_spec)
        positions = self._positions(batch, x.shape[1], x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.remat == "block" and torch.is_grad_enabled()
        for stacked, layers in self._units(params):
            kinds = tuple(kind for kind, _, _, _ in layers)
            ps = [p for _, _, _, p in layers]
            if stacked and remat:
                x, a = checkpoint(self._unit_fwd, kinds, ps, x, positions,
                                  use_reentrant=False)
            else:
                x, a = self._unit_fwd(kinds, ps, x, positions)
            aux = aux + a
        return x, aux

    def forward(self, params: Dict[str, Any], batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full-sequence pass -> (logits, hidden, aux_loss)."""
        with replicating(params):
            x, aux = self._hidden(params, batch)
            return self._head(params, x), x, aux

    def loss_fn(self, params: Dict[str, Any], batch: Dict[str, Any],
                z_loss: float = 0.0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, {"ce", "aux", "z"} and "mtp" with the MTP head) of
        next-token prediction against batch["labels"]: every codebook's
        for audio, the text tail's for a vlm batch with patches. The MTP
        loss enters the total at weight 0.3, as in the reference."""
        with replicating(params):
            logits, hidden, aux = self.forward(params, batch)
            labels = batch["labels"]
            if self.arch.vlm and "patch_embeds" in batch:
                logits = logits[:, -labels.shape[1]:]
            loss, z = cross_entropy(logits, labels, self.arch.vocab_size,
                                    z_loss)
            metrics = {"ce": loss, "aux": aux, "z": z}
            total = loss + aux
            if self.arch.mtp:
                metrics["mtp"] = self._mtp_loss(params, hidden, labels)
                total = total + 0.3 * metrics["mtp"]
            return total, metrics

    def _mtp_loss(self, params: Dict[str, Any], hidden: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
        """DeepSeek's multi-token prediction: labels[t + 1] (token t + 2)
        from [norm(h_t); norm(embed(labels_t))] @ proj through one more
        dense layer and the model's head."""
        arch = self.arch
        p = params["mtp"]
        h = rms_norm(hidden, p["norm_h"], arch.norm_eps)
        e = rms_norm(_lookup(params["embed"], labels), p["norm_e"],
                     arch.norm_eps)
        comb = torch.cat([h[:, :-1], e[:, :-1]], dim=-1) @ p["proj"]
        positions = torch.arange(comb.shape[1], device=comb.device)
        comb, _ = self._block_fwd("dense", p["layer"], comb, positions)
        loss, _ = cross_entropy(self._head(params, comb), labels[:, 1:],
                                arch.vocab_size)
        return loss

    def prefill(self, params: Dict[str, Any], batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(last-token logits (B, 1, V) or (B, 1, C, V), aux):
        ``forward(...)[0][:, -1:]`` without the head's work on the other
        positions."""
        with replicating(params):
            x, aux = self._hidden(params, batch)
            return self._head(params, x[:, -1:]), aux

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def _layer_cache_spec(self, kind: str, batch: int, cap: int):
        if kind == "rwkv":
            return rwkv_mod.rwkv_cache_spec(self.arch, batch,
                                            self.cache_dtype)
        if kind == "rglru":
            return rglru_mod.rglru_cache_spec(self.arch, batch,
                                              self.cache_dtype)
        if self.arch.attention == AttentionKind.MLA:
            return attn_mod.mla_cache_spec(self.arch, batch, cap,
                                           self.cache_dtype)
        if kind == "local_attn":
            cap = min(cap, self.arch.hybrid.window)
        return attn_mod.gqa_cache_spec(self.arch, self.padded, batch, cap,
                                       self.cache_dtype)

    def _layer_cache_axes(self, kind: str) -> Dict[str, Tuple]:
        if kind == "rwkv":
            return rwkv_mod.CACHE_AXES_RWKV
        if kind == "rglru":
            return rglru_mod.CACHE_AXES_RGLRU
        if self.arch.attention == AttentionKind.MLA:
            return attn_mod.CACHE_AXES_MLA
        return attn_mod.CACHE_AXES_GQA

    def cache_spec(self, batch: int, cap: int) -> Dict[str, Any]:
        """{..: (shape, dtype)} in the parameters' layout, plus "len"."""
        plan = self.plan

        def stacked(spec, n):
            return {k: ((n,) + shape, dt) for k, (shape, dt) in spec.items()}

        out: Dict[str, Any] = {"len": ((batch,), torch.int32)}
        if plan["kind"] == "hybrid":
            out["blocks"] = {
                f"sub{i}": stacked(self._layer_cache_spec(k, batch, cap),
                                   plan["n_super"])
                for i, k in enumerate(plan["pattern"])}
            for i, k in enumerate(plan["tail"]):
                out[f"tail{i}"] = self._layer_cache_spec(k, batch, cap)
        else:
            for key, kind, n in self._groups():
                out[key] = stacked(self._layer_cache_spec(kind, batch, cap),
                                   n)
        return out

    def cache_axes(self) -> Dict[str, Any]:
        """Each cache leaf's logical axes, in ``cache_spec``'s layout (a
        stacked leaf leads with "layers")."""
        plan = self.plan

        def stacked(axes):
            return {k: ("layers",) + v for k, v in axes.items()}

        out: Dict[str, Any] = {"len": (None,)}
        if plan["kind"] == "hybrid":
            out["blocks"] = {f"sub{i}": stacked(self._layer_cache_axes(k))
                             for i, k in enumerate(plan["pattern"])}
            for i, k in enumerate(plan["tail"]):
                out[f"tail{i}"] = self._layer_cache_axes(k)
        else:
            for key, kind, _ in self._groups():
                out[key] = stacked(self._layer_cache_axes(kind))
        return out

    def init_cache(self, batch: int, cap: int,
                   fill_len: int = 0) -> Dict[str, Any]:
        def build(node):
            if isinstance(node, tuple):
                shape, dt = node
                return torch.zeros(shape, dtype=dt, device=self.device)
            return {k: build(v) for k, v in node.items()}
        cache = build(self.cache_spec(batch, cap))
        cache["len"].fill_(fill_len)
        return cache

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _block_decode(self, kind: str, p, x, cache, cache_len):
        arch = self.arch
        # on DTensors a layer's sums may leave the stream partial; whole,
        # the projections split by head as the cache does
        x = _constrain(x, self.act_spec)
        h = rms_norm(x, p["ln1"], arch.norm_eps)
        if kind == "rwkv":
            mix, cache = rwkv_mod.time_mix_decode(p["tm"], h, cache, arch)
        elif kind == "rglru":
            mix, cache = rglru_mod.rglru_decode(p["rglru"], h, cache, arch)
        elif arch.attention == AttentionKind.MLA:
            mix, cache = attn_mod.mla_decode(p["attn"], h, cache, cache_len,
                                             arch)
        else:
            # local attention: a window-sized ring buffer, constant memory
            # in context length
            mix, cache = attn_mod.gqa_decode(p["attn"], h, cache, cache_len,
                                             arch, window=None,
                                             ring=kind == "local_attn")
        x = x + mix
        h = rms_norm(x, p["ln2"], arch.norm_eps)
        if kind == "rwkv":
            y, cache = rwkv_mod.channel_mix_decode(p["tm"], h, cache)
            return x + y, cache
        if kind == "moe":
            y, _ = moe_mod.moe_forward(p["moe"], h, arch)
            return x + y, cache
        return x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                          p["mlp"]["w_down"], arch.act), cache

    def decode_step(self, params: Dict[str, Any], cache: Dict[str, Any],
                    batch: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token serve step. batch['tokens']: (B, 1); for audio
        batch['embeds'] (B, 1, d) or batch['codes'] (B, 1, C), whose
        codebook embeddings are summed. Returns (logits, new cache); KV
        buffers are written in place, recurrent states are new tensors,
        and "len" advances for every lane."""
        with replicating(params):
            return self._decode_step(params, cache, batch)

    def _decode_step(self, params: Dict[str, Any], cache: Dict[str, Any],
                     batch: Dict[str, Any]
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        cache_len = cache["len"]
        x = self._decode_embed(params, batch)
        new_cache: Dict[str, Any] = {"len": cache_len + 1}
        per_layer: Dict[str, List] = {}
        views: Dict[str, List] = {}
        for (kind, key, s, p), (_, _, _, lc) in zip(self._walk(params),
                                                    self._walk(cache)):
            x, c = self._block_decode(kind, p, x, lc, cache_len)
            if s < 0:
                new_cache[key] = c
            else:
                per_layer.setdefault(key, []).append(c)
                views.setdefault(key, []).append(lc)
        if self.plan["kind"] == "hybrid":
            new_cache["blocks"] = {
                key: _restack(per_layer[key], views[key],
                              cache["blocks"][key]) for key in per_layer}
        else:
            for key in per_layer:
                new_cache[key] = _restack(per_layer[key], views[key],
                                          cache[key])
        return self._head(params, x), new_cache

    def _decode_embed(self, params: Dict[str, Any],
                      batch: Dict[str, Any]) -> torch.Tensor:
        arch = self.arch
        if not arch.n_codebooks:
            return self._embed(params, {"tokens": batch["tokens"]})
        if "embeds" in batch:
            return batch["embeds"]
        codes = batch["codes"].long()
        return torch.stack([params["embed_codes"][c][codes[..., c]]
                            for c in range(arch.n_codebooks)],
                           dim=2).sum(dim=2)
