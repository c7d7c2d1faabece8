"""Cell builder of the port (counterpart of ``repro.launch.cells``): (arch x
shape x mesh) -> a step with its argument records and placements.

For each cell ``build_cell`` gives:
  * the step function, run on the rank (the train step for train shapes,
    one decode step for prefill and decode shapes: the reference's
    ``serve_step``, ``serve_rows``: under a session mesh whose batch axes
    divide the batch, data parallel, each rank on its rows and its cache
    rows, as the reference's placements make GSPMD run it),
  * shape and dtype records of every argument (``meta`` tensors: params
    from their specs, the optimizer state from ``init_state`` on those,
    the decode cache from ``init_cache``), so nothing is allocated,
  * the placements of every argument and output, resolved from the
    logical annotations through ``launch.mesh.sharding_rules``: per mesh
    dim a ``Shard(d)`` or ``Replicate()``, as ``nn.module.param_shardings``
    gives them, in place of the reference's ``NamedSharding``s.

``nn.module.place_tree`` (and ``shard_params``, ``checkpoint.restore(...,
shardings=)``, ``FaultTolerantLoop.resume_or_init(..., shardings=)``)
realize them on a ``DeviceMesh`` of ranks. The mesh is an argument: a
``DeviceMesh``, or a ``launch.mesh.MeshShape`` where only the placements
are wanted. No TPU pod shape or peak constant is copied.

``RUN_HINTS`` are the reference's: FSDP for the models of 2B parameters
and more, microbatch accumulation for the train shape, bfloat16 params
and Adafactor for deepseek-v3. Placements are resolved internally on the
reference's mesh-axis tuples (one entry per tensor dim), so
``_truncate_sharding``, ``_opt_shardings`` and ``_zero1_shardings`` read
as the reference's, and turned into placements at the end.

``Cell.lower`` has no counterpart: torch has no ahead-of-time lowering.
It raises, naming the port's dry run, ``launch.dryrun.run_cell``, which
runs one rank's step on the cell's ``meta`` records and counts it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, RunConfig, Shape
from repro_torch.configs.registry import get_config
from repro_torch.core import colshard
from repro_torch.models.registry import get_model
from repro_torch.nn.module import (_placements, current_mesh, data_parallel,
                                   eval_shape_params, logical_to_mesh,
                                   mesh_sizes)
from repro_torch.train.trainer import _rows, make_train_step

from .mesh import batch_axes, sharding_rules

# how each arch runs at scale (param count driven)
RUN_HINTS: Dict[str, Dict[str, Any]] = {
    "moonshot-v1-16b-a3b": dict(fsdp=True, accum_steps=8),
    "deepseek-v3-671b": dict(fsdp=True, accum_steps=32,
                             param_dtype="bfloat16",
                             optimizer="adafactor",
                             opt_state_dtype="bfloat16"),
    "qwen3-0.6b": dict(fsdp=False, accum_steps=4),
    "llama3-8b": dict(fsdp=True, accum_steps=8),
    "granite-8b": dict(fsdp=True, accum_steps=8),
    "olmo-1b": dict(fsdp=False, accum_steps=4),
    "xlstm-1.3b": dict(fsdp=False, accum_steps=8),
    "llava-next-mistral-7b": dict(fsdp=True, accum_steps=8),
    "whisper-small": dict(fsdp=False, accum_steps=2),
    "zamba2-2.7b": dict(fsdp=True, accum_steps=8),
}

_LOWER = ("Cell.lower: torch has no ahead-of-time lowering; count the cell "
          "with repro_torch.launch.dryrun.run_cell, which runs one rank's "
          "step on its meta records")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: Shape
    cfg: ModelConfig
    mesh: Any
    step_fn: Callable            # positional args matching arg_structs
    arg_structs: Tuple           # meta tensors (no allocation)
    in_shardings: Tuple          # placements, one tuple per leaf
    out_shardings: Any
    donate: Tuple[int, ...]
    kind: str                    # train | prefill | decode

    rules: Any = None
    run: Optional[RunConfig] = None

    def lower(self):
        raise NotImplementedError(_LOWER)


# ---------------------------------------------------------------------------
# input stand-ins
# ---------------------------------------------------------------------------

def _struct(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_structs(cfg: ModelConfig, shape: Shape) -> Dict[str, torch.Tensor]:
    """Training batch stand-ins (tokens and the front end's stub)."""
    b, t = shape.global_batch, shape.seq_len
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "llava":
        text = t - cfg.n_frontend_tokens
        out["tokens"] = _struct((b, text + 1))
        out["frontend"] = _struct(
            (b, cfg.n_frontend_tokens, cfg.frontend_dim or cfg.d_model),
            torch.float32)
    elif cfg.family == "whisper":
        out["tokens"] = _struct((b, t + 1))
        out["frontend"] = _struct((b, cfg.n_frontend_tokens, cfg.d_model),
                                  torch.float32)
    else:
        out["tokens"] = _struct((b, t + 1))
    return out


def _pl(mesh, *spec) -> Tuple:
    """Placements over ``mesh``'s dims of a mesh-axis tuple ``spec``."""
    return _placements(tuple(spec), tuple(mesh.mesh_dim_names))


def batch_shardings(cfg: ModelConfig, mesh) -> Dict[str, Tuple]:
    b = batch_axes(mesh)
    sh = {"tokens": _pl(mesh, b)}
    if cfg.family in ("llava", "whisper"):
        sh["frontend"] = _pl(mesh, b)
    return sh


def _dim_axis_ok(dim: int, mesh, axes) -> bool:
    if axes is None:
        return False
    ax = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_sizes(mesh)
    n = 1
    for a in ax:
        n *= sizes[a]
    return dim % n == 0 and dim >= n


def cache_shardings(cache_struct, cfg: ModelConfig, mesh):
    """Decode-cache placements: the batch dim over the batch axes where they
    divide it; the time of K/V, their int8 scales and MLA's latent cache,
    and the SSD state's heads, over ``"model"`` where its ranks divide
    them (``models.layers.cache_leaf`` allocates the caches so)."""
    b = batch_axes(mesh)

    def leaf_spec(path, leaf):
        shape = leaf.shape
        spec = [None] * len(shape)
        # all caches are stacked (L, B, ...) except whisper's enc_out
        # (B, F, D)
        name = path[-1] if path else ""
        if name == "enc_out":
            if _dim_axis_ok(shape[0], mesh, b):
                spec[0] = b
            return _pl(mesh, *spec)
        if len(shape) >= 2:
            if _dim_axis_ok(shape[1], mesh, b):
                spec[1] = b
        if name in ("k", "v", "ckv", "krope", "k_scale", "v_scale") \
                and len(shape) >= 3:
            if _dim_axis_ok(shape[2], mesh, "model"):
                spec[2] = "model"
        if name in ("ssd",) and len(shape) >= 3:
            if _dim_axis_ok(shape[2], mesh, "model"):
                spec[2] = "model"
        return _pl(mesh, *spec)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, path + (str(i),))
                              for i, v in enumerate(tree))
        return leaf_spec(path, tree)

    return walk(cache_struct)


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------

def make_run_config(arch: str, shape: Shape, *, accum: Optional[int] = None,
                    run_overrides: Optional[Dict[str, Any]] = None
                    ) -> RunConfig:
    hints = dict(RUN_HINTS.get(arch, {}))
    if run_overrides:
        hints.update(run_overrides)
    return RunConfig(
        fsdp=hints.get("fsdp", False),
        accum_steps=(accum if accum is not None
                     else (hints.get("accum_steps", 1)
                           if shape.kind == "train" else 1)),
        accum_unroll=hints.get("accum_unroll", False),
        optimizer=hints.get("optimizer", "adamw"),
        opt_state_dtype=hints.get("opt_state_dtype", "float32"),
    )


def apply_hints(cfg: ModelConfig, arch: str) -> ModelConfig:
    hints = RUN_HINTS.get(arch, {})
    kw = {}
    if "param_dtype" in hints:
        kw["param_dtype"] = hints["param_dtype"]
    return cfg.replace(**kw) if kw else cfg


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (mesh-axis tuples and tensors are
    leaves), with the matching nodes of ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _to_placements(spec_tree, mesh):
    return _map(lambda s: _pl(mesh, *s), spec_tree)


def build_cell(arch: str, shape_name, mesh, *,
               reduced: bool = False, cim=None,
               accum: Optional[int] = None,
               overrides: Optional[Dict[str, Any]] = None,
               run_overrides: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell of ``arch`` at ``shape_name`` (a name of ``SHAPES``, or a
    ``Shape`` of its own: a batch or length the registry does not name)
    on ``mesh``."""
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    cfg = get_config(arch, reduced=reduced, cim=cim)
    cfg = apply_hints(cfg, arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    run = make_run_config(arch, shape, accum=accum,
                          run_overrides=run_overrides)
    zero1 = bool((run_overrides or {}).get(
        "zero1", RUN_HINTS.get(arch, {}).get("zero1", False)))
    model = get_model(cfg)
    rules = sharding_rules(mesh, fsdp=run.fsdp)

    specs = model.specs(cfg)
    params_struct = eval_shape_params(specs)
    # drop mesh axes on dims they don't divide (odd vocabs, 4d/3 FFNs, ...)
    params_sp = _map(lambda ps, st: _truncate_sharding(ps, st, mesh),
                     logical_to_mesh(specs, rules), params_struct)
    params_sh = _to_placements(params_sp, mesh)

    if shape.kind == "train":
        init_state, train_step = make_train_step(model, cfg, run)
        opt_struct = init_state(params_struct)
        opt_sp = _opt_shardings(opt_struct, params_sp, mesh)
        if zero1:
            # ZeRO-1: optimizer states over the batch axes although the
            # params are replicated there: one param all-gather per step
            opt_sp = _zero1_shardings(opt_sp, opt_struct, mesh)
        opt_sh = _to_placements(opt_sp, mesh)
        bstructs = batch_structs(cfg, shape)
        bsh = batch_shardings(cfg, mesh)
        metrics_sh = _pl(mesh)
        return Cell(
            arch=arch, shape=shape, cfg=cfg, mesh=mesh, kind="train",
            rules=rules, run=run,
            step_fn=train_step,
            arg_structs=(params_struct, opt_struct, bstructs),
            in_shardings=(params_sh, opt_sh, bsh),
            out_shardings=(params_sh, opt_sh,
                           {k: metrics_sh for k in ("loss", "grad_norm",
                                                    "lr", "step")}),
            donate=(0, 1),
        )

    # inference shapes
    b = shape.global_batch
    if shape.kind == "prefill":
        tok_len = shape.seq_len
        cache_len = shape.seq_len
    else:                                    # decode: one token, full cache
        tok_len = 1
        cache_len = shape.seq_len
        # single-query attention over the time-sharded cache needs no KV
        # chunking
        cfg = cfg.replace(attn_chunk=0)
    cache_struct = model.init_cache(cfg, b, cache_len, device="meta")
    cache_sh = cache_shardings(cache_struct, cfg, mesh)
    tok_struct = _struct((b, tok_len))
    bspec = batch_axes(mesh) if _dim_axis_ok(b, mesh, batch_axes(mesh)) \
        else None
    tok_sh = _pl(mesh, bspec)

    def serve_step(params, cache, tokens, frontend=None):
        return serve_rows(model, cfg, params, cache, tokens, frontend)

    vspec = "model" if _dim_axis_ok(cfg.vocab, mesh, "model") else None
    logits_sh = _pl(mesh, bspec, None, vspec)
    return Cell(
        arch=arch, shape=shape, cfg=cfg, mesh=mesh, kind=shape.kind,
        rules=rules, run=run,
        step_fn=serve_step,
        arg_structs=(params_struct, cache_struct, tok_struct),
        in_shardings=(params_sh, cache_sh, tok_sh),
        out_shardings=(logits_sh, cache_sh),
        donate=(1,),
    )


# ---------------------------------------------------------------------------
# the serve step: data parallel over the batch axes
# ---------------------------------------------------------------------------

def _cache_map(fn, tree, *rest):
    """``fn`` over the leaves of a cache tree and the matching leaves of
    ``rest`` (tuples stay tuples: xlstm's ``cell``)."""
    if isinstance(tree, dict):
        return {k: _cache_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cache_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _placed_logits(logits: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Logits (rows, T, V) placed as the reference's ``logits_sh``: rows
    over the batch ``axes`` (the rank's own already), the vocab over
    ``"model"`` where its ranks divide it (this rank's block of the
    whole-vocab logits the LM head gathered). Plain without a split."""
    dims = {0: axes} if axes else {}
    n_model = colshard.mesh_shards(mesh, "model")
    v = logits.shape[-1]
    if n_model > 1 and v % n_model == 0:
        w = v // n_model
        logits = logits.narrow(-1, colshard.mesh_coord(mesh, "model") * w,
                               w)
        dims[2] = ("model",)
    if not dims:
        return logits
    shape = list(logits.shape)
    shape[0] *= colshard.batch_shard(mesh, axes)[0] if axes else 1
    shape[2] = v
    return colshard.placed(logits.contiguous(), mesh,
                           colshard.placements_of(mesh, dims), tuple(shape))


def _decode(model, cfg: ModelConfig, params, cache, tokens, frontend):
    """The model's decode step; with ``frontend`` a prefill that reads the
    front-end input of these rows first: whisper's encoder states written
    into the cache's ``enc_out`` rows, llava's image embeddings before the
    prompt."""
    if frontend is None:
        return model.decode_step(params, cache, tokens, cfg)
    if cfg.family == "whisper":
        from repro_torch.models import whisper
        cache["enc_out"].copy_(whisper.encode(params, frontend, cfg))
        return model.decode_step(params, cache, tokens, cfg)
    if cfg.family == "llava":
        from repro_torch.models import llava
        return llava.decode_step(params, cache, tokens, cfg,
                                 frontend=frontend)
    raise ValueError(f"a {cfg.family} serve step takes no front-end input")


def serve_rows(model, cfg: ModelConfig, params, cache, tokens,
               frontend=None):
    """One serve step (the reference's ``serve_step``: a prefill of T
    tokens or a decode step) on this rank: (logits, cache), the logits
    placed as the reference's ``logits_sh``, the cache written in place.

    Under a session mesh whose batch axes (of more than one rank) divide
    the batch (``models.layers.rows_axes``; the reference's ``bspec``)
    the step is data parallel: ``tokens`` (and ``frontend``) are the
    global batch, the rank takes its rows, and its decode step runs on
    them and on its rows of the cache (each leaf placed with its rows
    over the batch axes, as ``init_cache`` makes it under that mesh, read
    through ``colshard.rows_view``, which keeps a time or heads split over
    ``"model"`` for the layers that read it) inside
    ``nn.module.data_parallel``: every layer below sees B/D rows, so no
    activation row crosses the batch axes, and the logits and cache come
    back placed over them. Elsewhere the rows stay whole on every rank
    (``long_500k``'s batch of 1)."""
    from repro_torch.models.layers import rows_axes
    mesh = current_mesh()
    axes = rows_axes(tokens.shape[0])
    if not axes:
        logits, new = _decode(model, cfg, params, cache, tokens, frontend)
        return (_placed_logits(logits, mesh, ()) if mesh is not None
                else logits), new
    view = _cache_map(lambda x: colshard.rows_view(x, axes), cache)
    batch = _rows({"tokens": tokens} if frontend is None else
                  {"tokens": tokens, "frontend": frontend}, mesh, axes)
    with data_parallel(mesh, axes):
        logits, new = _decode(model, cfg, params, view, batch["tokens"],
                              batch.get("frontend"))
    new = _cache_map(lambda n, ref: colshard.like(ref, colshard.local(n)),
                     new, cache)
    return _placed_logits(logits, mesh, axes), new


def _opt_shardings(opt_struct, params_sp, mesh):
    """Optimizer state mirrors the parameter placements (m/v/mom follow
    their parameter; adafactor's vr/vc follow with the reduced dim dropped;
    scalars replicated). Mesh-axis tuples in, mesh-axis tuples out."""
    flat_p = dict(_flatten_tree(params_sp))

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        sub = path[1:]                     # drop the state kind (m/v/mom/..)
        if not sub:                        # e.g. "step"
            return ()
        key = "/".join(sub)
        if key in flat_p:
            return _truncate_sharding(flat_p[key], tree, mesh)
        name = sub[-1]
        pkey = "/".join(sub[:-1])
        if name in ("vr", "vc", "v") and pkey in flat_p:
            spec = list(flat_p[pkey])
            spec += [None] * (len(tree.shape) + 2 - len(spec))
            if name == "vr":               # param reduced over last dim
                spec = spec[:len(tree.shape)]
            elif name == "vc":             # param reduced over dim -2
                spec = spec[:len(tree.shape) - 1] + [spec[len(tree.shape)]]
            else:
                spec = spec[:len(tree.shape)]
            return _truncate_sharding(tuple(spec), tree, mesh)
        return ()

    return walk(opt_struct)


def _truncate_sharding(spec: Tuple, leaf, mesh) -> Tuple:
    """Fit a parameter's mesh-axis tuple onto a (possibly lower-rank)
    leaf: drop the axes that no longer divide their dim."""
    spec = list(spec) + [None] * 8
    sizes = mesh_sizes(mesh)
    out = []
    for i in range(len(leaf.shape)):
        ax = spec[i]
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        n = 1
        for a in axes:
            n *= sizes[a]
        out.append(ax if leaf.shape[i] % n == 0 and leaf.shape[i] >= n
                   else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _zero1_shardings(opt_sp, opt_struct, mesh):
    """Add the batch axes to optimizer-state leaves on their first
    divisible, unsplit dim (ZeRO-1)."""
    b = batch_axes(mesh)
    sizes = mesh_sizes(mesh)
    nb = 1
    for a in b:
        nb *= sizes[a]

    def walk(sp, st):
        if isinstance(sp, dict):
            return {k2: walk(sp[k2], st[k2]) for k2 in sp}
        if not st.shape:                      # scalars (step) stay replicated
            return sp
        spec = list(sp) + [None] * (len(st.shape) - len(sp))
        used = {a for s in spec if s is not None
                for a in ((s,) if isinstance(s, str) else s)}
        if any(a in used for a in b):
            return sp                          # already split over batch
        for i, dim in enumerate(st.shape):
            if spec[i] is None and dim % nb == 0 and dim >= nb:
                spec[i] = b if len(b) > 1 else b[0]
                return tuple(spec)
        return sp

    return walk(opt_sp, opt_struct)


def _flatten_tree(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_tree(v, path + (k,))
    else:
        yield "/".join(path), tree
