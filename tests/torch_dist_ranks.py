"""Rank bodies for ``tests/test_torch_dist.py``.

Each function here runs in one spawned rank of a gloo process group
(``run_rank``) and returns a picklable result; the test process holds
the results against the JAX package. This module imports torch and the
port only, never JAX: the ranks are the port alone.
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch

TIMEOUT_S = 60


def run_rank(rank, world, store, fn_name, kwargs, out_dir):
    """Join the group through a FileStore, run ``fn_name``, write the
    result to ``out_dir/rank<rank>.pkl``."""
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = globals()[fn_name](rank, world, **kwargs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy()


def _flat_np(tree):
    from parallax_tpu_torch.core.classify import flatten
    return {p: _np(t) for p, t in flatten(tree)}


# -- (a) the sharded lookup ---------------------------------------------------


def lookup(rank, world, shapes, table, cases):
    """For each mesh shape, each case: (name, kw, [(ids, cot)]): forward
    rows and the table shard's gradient of sum(rows * cot), per
    lookup."""
    return {tuple(shape): _lookup(rank, world, shape, table, cases)
            for shape in shapes}


def _lookup(rank, world, shape, table, cases):
    from parallax_tpu_torch.core import mesh as mesh_lib
    from parallax_tpu_torch.ops import embedding

    mesh = mesh_lib.build_mesh("cpu", shape=shape)
    r, s = mesh.coords
    V = table.shape[0]
    rows_here = V // mesh.shard
    out = {"coords": (r, s)}
    for name, kw, steps in cases:
        res = []
        for ids, cot in steps:
            n = ids.shape[0] // world
            shard = torch.tensor(table[s * rows_here:(s + 1) * rows_here],
                                 requires_grad=True)
            ids_l = torch.from_numpy(ids[rank * n:(rank + 1) * n])
            cot_l = torch.from_numpy(cot[rank * n:(rank + 1) * n])
            records = []
            with embedding.sharded_lookup_scope(
                    mesh, [(shard, table.shape, "emb")], records=records,
                    **kw) as ctx:
                rows = embedding.embedding_lookup(shard, ids_l)
            (rows * cot_l).sum().backward()
            res.append({"rows": _np(rows), "grad": _np(shard.grad),
                        "guarded": list(ctx.guarded),
                        "records": records})
        out[name] = res
    return out


# -- the toy model of tests/test_hybrid_e2e.py --------------------------------


def toy_model(lr=0.1):
    """``_make_model`` of tests/test_hybrid_e2e.py in the port; the loss
    and metric are global means."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core import optim
    from parallax_tpu_torch.ops import collectives, embedding

    V, D, H = 32, 8, 4

    def init_fn(gen, device):
        return {"emb": torch.randn((V, D), generator=gen, device=device),
                "proj": {"w": torch.randn((D, H), generator=gen,
                                          device=device)}}

    def loss_fn(params, batch):
        rows = embedding.embedding_lookup(params["emb"], batch["ids"])
        h = rows @ params["proj"]["w"]
        loss = collectives.global_mean((h - batch["y"]) ** 2)
        return loss, {"h_norm": collectives.global_mean(h ** 2)}

    return pt.Model(init_fn, loss_fn, optimizer=optim.sgd(lr))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _load(sess, init, example):
    """Copy the whole JAX tree ``init`` (numpy leaves, the port's layout)
    into the session's state as this rank holds it."""
    from parallax_tpu_torch import weights
    from parallax_tpu_torch.core.classify import flatten
    sess.prepare(example)
    mine = dict(flatten(weights.rank_shard(_to_torch(init), sess.engine)))
    with torch.no_grad():
        for path, leaf in flatten(sess.state.params):
            leaf.copy_(mine[path])


def _share(batch, rank, world):
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def toy(rank, world, runs, init, batches):
    """Each run: (name, Config kwargs, parallel_run kwargs); the
    losses, metrics, the whole parameters after the steps, the plan and
    the wire bytes."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.common.config import PSConfig

    out = {}
    for name, cfg_kw, run_kw in runs:
        cfg_kw = dict(cfg_kw)
        ps = cfg_kw.pop("ps", None)
        config = pt.Config(**cfg_kw)
        if ps:
            config.communication_config.ps_config = PSConfig(**ps)
        sess, n_workers, worker_id, n_rep = pt.parallel_run(
            toy_model(), parallax_config=config, device="cpu", **run_kw)
        _load(sess, init, _share(batches[0], rank, world))
        losses, norms = [], []
        for b in batches:
            loss, h_norm = sess.run(["loss", "h_norm"],
                                    feed_dict=_share(b, rank, world))
            losses.append(float(loss))
            norms.append(float(h_norm))
        out[name] = {
            "returned": (n_workers, worker_id, n_rep),
            "mesh": (sess.mesh.repl, sess.mesh.shard, sess.mesh.coords,
                     sess.mesh.shard_group.ranks,
                     sess.mesh.repl_group.ranks),
            "losses": losses, "h_norm": norms,
            "params": _flat_np(sess.gather_params()),
            "local_shapes": {p: tuple(v.shape) for p, v in
                             _flat_np(sess.state.params).items()},
            "placements": dict(sess.engine.plan.placements),
            "eager_steps": sess.compile_stats().get("eager_steps"),
            "wire": sess.sparse_wire_bytes_per_step()}
        sess.close()
    return out


# -- LM1B and NMT ------------------------------------------------------------


def _fake_candidates(ids_list):
    """Hand the JAX session's sampled-softmax candidates to the port, one
    list a step (the meta passes of the build draw none)."""
    from parallax_tpu_torch.ops import sampled_softmax
    it = iter(ids_list)

    def fake(gen, num_samples, vocab_size, device=None):
        if torch.device(device).type == "meta":
            return torch.zeros((num_samples,), dtype=torch.long,
                               device="meta")
        return torch.tensor(next(it), dtype=torch.long, device=device)

    sampled_softmax.log_uniform_candidates = fake


def lm1b(rank, world, cfg_kw, config_kw, shape, init, batches, candidates):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import lm1b as tlm1b
    from parallax_tpu_torch.ops import sparse_optim

    _fake_candidates(candidates)
    cfg = tlm1b.tiny_config(compute_dtype=torch.float32, lstm_impl="kernel",
                            **cfg_kw)
    sess, *_ = pt.parallel_run(
        tlm1b.build_model(cfg), parallax_config=pt.Config(**config_kw),
        device="cpu", num_partitions=shape[1])
    _load(sess, init, _share(batches[0], rank, world))
    out = [sess.run(["loss", "words"], feed_dict=_share(b, rank, world))
           for b in batches]
    res = {"losses": [float(o[0]) for o in out],
           "words": [float(o[1]) for o in out],
           "local_words": [float(_share(b, rank, world)["w"].sum())
                           for b in batches],
           "mesh": (sess.mesh.repl, sess.mesh.shard),
           "placements": dict(sess.engine.plan.placements),
           "params": _flat_np(sess.gather_params()),
           "overflow": sparse_optim.collect_overflow_steps(
               sess.state.opt_state),
           "wire": sess.sparse_wire_bytes_per_step()}
    sess.close()
    return res


def nmt(rank, world, cfg_kw, init, batches):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch import weights
    from parallax_tpu_torch.core.classify import flatten
    from parallax_tpu_torch.models import nmt as tnmt
    from parallax_tpu_torch.weights import params_from_jax

    cfg = tnmt.tiny_config(compute_dtype=torch.float32, **cfg_kw)
    sess, *_ = pt.parallel_run(
        tnmt.build_model(cfg),
        parallax_config=pt.Config(run_option="HYBRID"), device="cpu")
    sess.prepare(_share(batches[0], rank, world))
    mine = dict(flatten(weights.rank_shard(
        params_from_jax(init, cfg, "cpu"), sess.engine)))
    with torch.no_grad():
        for path, leaf in flatten(sess.state.params):
            leaf.copy_(mine[path])
    out = [sess.run(["loss", "words"], feed_dict=_share(b, rank, world))
           for b in batches]
    res = {"losses": [float(o[0]) for o in out],
           "words": [float(o[1]) for o in out],
           "placements": dict(sess.engine.plan.placements),
           "params": _flat_np(sess.gather_params())}
    sess.close()
    return res


# -- tensor parallelism (tests/test_torch_tp.py) ------------------------------


def tp_part(w, kind, groups, s, p):
    """Rank ``s`` of ``p``'s part of a whole weight (numpy): its columns of
    each of ``groups`` blocks ("col"), its rows ("row"), or the whole."""
    if kind == "col":
        blocks = w.reshape(w.shape[:-1] + (groups, -1))
        n = blocks.shape[-1] // p
        return blocks[..., s * n:(s + 1) * n].reshape(w.shape[:-1] + (-1,))
    if kind == "row":
        n = w.shape[0] // p
        return w[s * n:(s + 1) * n]
    return w


def _tp_case(mesh, case):
    """One op-level case on this rank: (outputs, input grads, local
    weight grads, collective counts of the forward)."""
    from parallax_tpu_torch.ops import tensor_parallel as tp
    name, fn_name, inputs, weights, kw, cot = case
    s, p = mesh.coords[1], mesh.shard
    sp = kw.get("sequence_parallel", False)

    def local_input(a):
        t = torch.tensor(a)
        if sp:               # this rank's T/p of the sequence
            n = t.shape[1] // p
            t = t[:, s * n:(s + 1) * n]
        return t.clone().requires_grad_()

    xs = {k: local_input(v) for k, v in inputs.items()}
    ws = {k: torch.tensor(tp_part(w, kind, g, s, p)).requires_grad_()
          for k, (w, kind, g) in weights.items()}
    kwargs = dict(kw)
    heads = kwargs.pop("heads", None)
    if "kv_mask" in kwargs:
        kwargs["kv_mask"] = torch.tensor(kwargs["kv_mask"])

    def run():
        if fn_name == "column_row":
            return tp.row_parallel(tp.column_parallel(
                xs["x"], ws["w1"], mesh=mesh, **kwargs), ws["w2"],
                mesh=mesh, **kwargs)
        if fn_name == "mlp":
            return tp.tp_mlp(xs["x"], ws["w1"], ws["w2"], mesh=mesh,
                             **kwargs)
        attn = {k: ws[k] for k in ("wqkv", "wq", "wk", "wv", "wo")
                if k in ws}
        if fn_name == "attention":
            x_kv = xs["x_kv"] if "x_kv" in xs else xs["x"]
            return tp.tp_attention(xs["x"], x_kv, attn, heads, mesh=mesh,
                                   **kwargs)
        # the Megatron block of tests/test_tensor_parallel.py:_block_fwd
        x = xs["x"]
        y = x + tp.tp_attention(x, x, attn, heads, mesh=mesh, **kwargs)
        return y + tp.tp_mlp(y, ws["w1"], ws["w2"], mesh=mesh,
                             sequence_parallel=sp)

    counts = tp.count_collectives(lambda: run())
    out = run()
    c = torch.tensor(cot)
    if sp:
        n = c.shape[1] // p
        c = c[:, s * n:(s + 1) * n]
    (out * c).sum().backward()
    return {"out": _np(out), "counts": counts,
            "x_grads": {k: _np(v.grad) for k, v in xs.items()},
            "w_grads": {k: _np(v.grad) for k, v in ws.items()}}


def tp_ops(rank, world, cases, norm_leaves):
    """Each op-level case on a (1, world) mesh, and ``global_norm`` over
    this rank's parts of ``norm_leaves`` ({path: (whole, kind,
    groups)}) with the split ones named in ``sharded_scope``."""
    from parallax_tpu_torch.core import mesh as mesh_lib, optim
    mesh = mesh_lib.build_mesh("cpu", shape=(1, world))
    s = mesh.coords[1]
    parts = {k: torch.tensor(tp_part(w, kind, g, s, world))
             for k, (w, kind, g) in norm_leaves.items()}
    split = [k for k, (_, kind, _) in norm_leaves.items() if kind != "rep"]
    with optim.sharded_scope(split, mesh):
        norm = float(optim.global_norm(parts))
    return {"coords": mesh.coords, "global_norm": norm,
            **{case[0]: _tp_case(mesh, case) for case in cases}}


def _row_share(batch, mesh):
    """This rank's feed when the batch rides 'repl' alone: its repl row's
    share, alike across its shard group."""
    r = mesh.coords[0]
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // mesh.repl
        out[k] = v[r * n:(r + 1) * n]
    return out


def tp_models(rank, world, runs):
    """Each run: (name, model family, config kwargs, num_partitions,
    feed layout, SGD learning rate or None for the model's own
    optimizer, whole initial params, batches): losses, the gathered
    parameters, the local shapes and the plan."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch import weights
    from parallax_tpu_torch.core import optim
    from parallax_tpu_torch.core.classify import flatten
    from parallax_tpu_torch.models import bert as tbert, nmt as tnmt

    out = {}
    for name, family, cfg_kw, parts, feed, sgd, init, batches in runs:
        if family == "bert":
            cfg = tbert.tiny_config(compute_dtype=torch.float32, **cfg_kw)
            model = tbert.build_model(cfg)
            whole = weights.bert_params_from_jax(init, cfg, "cpu")
        else:
            cfg = tnmt.tiny_config(compute_dtype=torch.float32, **cfg_kw)
            model = tnmt.build_model(cfg)
            whole = weights.params_from_jax(init, cfg, "cpu")
        if sgd is not None:
            model.optimizer = optim.sgd(sgd)
        sess, *_ = pt.parallel_run(
            model, parallax_config=pt.Config(run_option="HYBRID"),
            device="cpu", num_partitions=parts)
        mesh = sess.mesh

        def share(b):
            return _row_share(b, mesh) if feed == "repl" \
                else _share(b, rank, world)

        sess.prepare(share(batches[0]))
        mine = dict(flatten(weights.rank_shard(whole, sess.engine)))
        with torch.no_grad():
            for path, leaf in flatten(sess.state.params):
                leaf.copy_(mine[path])
        losses = [float(sess.run("loss", feed_dict=share(b)))
                  for b in batches]
        out[name] = {
            "mesh": (mesh.repl, mesh.shard, mesh.coords),
            "losses": losses,
            "params": _flat_np(sess.gather_params()),
            "local_shapes": {p: tuple(v.shape) for p, v in
                             _flat_np(sess.state.params).items()},
            "placements": dict(sess.engine.plan.placements),
            "wire": sess.sparse_wire_bytes_per_step()}
        sess.close()
    return out


# -- ring attention and the long-context LM (tests/test_torch_ring_attention
# .py, tests/test_torch_long_context.py) ------------------------------------


def ring_ops(rank, world, cases):
    """Each case (name, placement, causal, block_impl, q, k, v, cot), the
    arrays global [B, T, H, D] (already zig-zag permuted for
    ``placement='zigzag'``): this rank's output block and its q, k, v
    gradients of sum(out * cot), and the collectives of the forward."""
    from parallax_tpu_torch.core import mesh as mesh_lib
    from parallax_tpu_torch.ops import ring_attention as ra
    from parallax_tpu_torch.ops import tensor_parallel as tp
    mesh = mesh_lib.build_mesh("cpu", shape=(1, world))
    s = mesh.coords[1]
    out = {"coords": mesh.coords}
    for name, placement, causal, impl, q, k, v, cot in cases:
        n = q.shape[1] // world
        blk = slice(s * n, (s + 1) * n)
        xs = [torch.tensor(a[:, blk]).requires_grad_() for a in (q, k, v)]

        def run():
            return ra.ring_attention(*xs, mesh, "shard", causal=causal,
                                     placement=placement, block_impl=impl)

        counts = tp.count_collectives(lambda: run())
        y = run()
        (y * torch.tensor(cot[:, blk])).sum().backward()
        out[name] = {"out": _np(y), "grads": [_np(x.grad) for x in xs],
                     "counts": counts}
    return out


def lc_models(rank, world, runs):
    """Each run: (name, config kwargs, mesh shape, feed layout, SGD
    learning rate or None for the model's own optimizer, whole initial
    params, batches): losses, tokens, the gathered parameters, the local
    shapes, the plan and the batch layout."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch import weights
    from parallax_tpu_torch.core import optim
    from parallax_tpu_torch.core.classify import flatten
    from parallax_tpu_torch.models import long_context as tlc

    out = {}
    for name, cfg_kw, shape, feed, sgd, init, batches in runs:
        if shape[0] * shape[1] != world:
            continue
        cfg = tlc.tiny_config(compute_dtype=torch.float32, **cfg_kw)
        model = tlc.build_model(cfg)
        if sgd is not None:
            model.optimizer = optim.sgd(sgd)
        sess, *_ = pt.parallel_run(
            model, parallax_config=pt.Config(run_option="HYBRID"),
            device="cpu", num_partitions=shape[1])
        mesh = sess.mesh

        def share(b):
            return _row_share(b, mesh) if feed == "repl" \
                else _share(b, rank, world)

        sess.prepare(share(batches[0]))
        mine = dict(flatten(weights.long_context_params_from_jax(
            init, cfg, "cpu", engine=sess.engine)))
        with torch.no_grad():
            for path, leaf in flatten(sess.state.params):
                leaf.copy_(mine[path])
        losses, tokens = [], []
        for b in batches:
            loss, tok = sess.run(["loss", "tokens"], feed_dict=share(b))
            losses.append(float(loss))
            tokens.append(float(tok))
        out[name] = {
            "mesh": (mesh.repl, mesh.shard, mesh.coords),
            "losses": losses, "tokens": tokens,
            "params": _flat_np(sess.gather_params()),
            "local_shapes": {p: tuple(v.shape) for p, v in
                             _flat_np(sess.state.params).items()},
            "placements": dict(sess.engine.plan.placements),
            "layout": sess.engine.batch_layout}
        sess.close()
    return out


# -- the switch MoE and the MoE LM (tests/test_torch_moe.py,
# tests/test_torch_moe_lm.py) -------------------------------------------------


def moe_ops(rank, world, shapes, cases):
    """For each mesh shape, each case (name, tokens [B, D], router, w1,
    w2, capacity factor, k, cot, aux weight): this rank's rows of
    ``switch_moe``'s output over its own experts (E/n of the whole
    weights where the shard axis divides E, else all E), the aux loss
    and dropped share, the collectives of the forward, the gradient of
    its tokens and the world's sums of the router's and experts'
    gradients of sum(out * cot) + c aux (the aux term divided by the
    world, whose ``global_sum`` backward scales it back), each expert
    gradient in its place in the whole weights."""
    from parallax_tpu_torch.core import mesh as mesh_lib
    from parallax_tpu_torch.ops import collectives, moe

    out = {}
    for shape in shapes:
        mesh = mesh_lib.build_mesh("cpu", shape=tuple(shape))
        res = {"coords": mesh.coords}
        for name, x, router, w1, w2, cf, k, cot, c in cases:
            n = x.shape[0] // world
            rows = slice(rank * n, (rank + 1) * n)
            e = w1.shape[0]
            mine = slice(0, e)
            if e % mesh.shard == 0:
                e_per = e // mesh.shard
                mine = slice(mesh.coords[1] * e_per,
                             (mesh.coords[1] + 1) * e_per)
            xs = [torch.tensor(a).requires_grad_() for a in
                  (x[rows], router, w1[mine], w2[mine])]

            def run():
                return moe.switch_moe(*xs, mesh, capacity_factor=cf,
                                      top_k=k)

            with torch.no_grad(), collectives.count_scope() as counts:
                run()
            y, aux, dropped = run()
            loss = (y * torch.tensor(cot[rows])).sum() + c * aux / world
            loss.backward()
            sums = [xs[1].grad.clone()]
            for w, x_ in zip((w1, w2), xs[2:]):
                whole = torch.zeros(w.shape)
                whole[mine] = x_.grad
                sums.append(whole)
            for g in sums:
                collectives.all_reduce_(g, mesh.world)
            res[name] = {"out": _np(y), "aux": float(aux),
                         "dropped": float(dropped), "counts": dict(counts),
                         "x_grad": _np(xs[0].grad),
                         "w_grads": [_np(g) for g in sums]}
        try:
            moe.switch_moe(torch.tensor(cases[0][1][:4]),
                           torch.tensor(cases[0][2]),
                           torch.tensor(cases[0][3]),
                           torch.tensor(cases[0][4]), mesh, top_k=0)
            res["top_k_error"] = None
        except ValueError as e:
            res["top_k_error"] = str(e)
        out[tuple(shape)] = res
    return out


def moe_models(rank, world, runs):
    """Each run: (name, config kwargs, mesh shape, SGD learning rate or
    None for the model's own optimizer, whole initial params, batches):
    losses and metrics, the gathered parameters, the local shapes, the
    plan and the collectives of one step."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch import weights
    from parallax_tpu_torch.core import optim
    from parallax_tpu_torch.core.classify import flatten
    from parallax_tpu_torch.models import moe_lm
    from parallax_tpu_torch.ops import collectives

    out = {}
    for name, cfg_kw, shape, sgd, init, batches in runs:
        if shape[0] * shape[1] != world:
            continue
        cfg = moe_lm.tiny_config(compute_dtype=torch.float32, **cfg_kw)
        model = moe_lm.build_model(cfg)
        if sgd is not None:
            model.optimizer = optim.sgd(sgd)
        sess, *_ = pt.parallel_run(
            model, parallax_config=pt.Config(run_option="HYBRID"),
            device="cpu", num_partitions=shape[1])
        mesh = sess.mesh
        sess.prepare(_share(batches[0], rank, world))
        mine = dict(flatten(weights.moe_lm_params_from_jax(
            init, cfg, "cpu", engine=sess.engine)))
        with torch.no_grad():
            for path, leaf in flatten(sess.state.params):
                leaf.copy_(mine[path])
        metrics = {k: [] for k in ("loss", "lm_loss", "aux_loss",
                                   "moe_dropped")}
        counts = None
        for b in batches:
            with collectives.count_scope() as c:
                vals = sess.run(list(metrics),
                                feed_dict=_share(b, rank, world))
            counts = counts or dict(c)
            for k, v in zip(metrics, vals):
                metrics[k].append(float(v))
        out[name] = {
            "mesh": (mesh.repl, mesh.shard, mesh.coords),
            **metrics, "counts": counts,
            "params": _flat_np(sess.gather_params()),
            "local_shapes": {p: tuple(v.shape) for p, v in
                             _flat_np(sess.state.params).items()},
            "placements": dict(sess.engine.plan.placements)}
        sess.close()
    return out


# -- checkpoints across layouts (test_torch_ckpt.py) --------------------------


def ckpt_toy(rank, world, jobs, init, batches):
    """Each job: (checkpoint dir, save cadence, stop): the toy model under
    HYBRID with its checkpoints in that dir, on this mesh (one shard
    column per rank), from the newest checkpoint (from ``init`` when
    there is none) through ``batches[:stop]``. Returns per job the
    restored step, the losses and the whole parameters after."""
    import parallax_tpu_torch as pt

    out = []
    for ckpt_dir, every, stop in jobs:
        cfg = pt.Config(run_option="HYBRID", ckpt_config=pt.CheckPointConfig(
            ckpt_dir=ckpt_dir, save_ckpt_steps=every))
        sess, *_ = pt.parallel_run(toy_model(), parallax_config=cfg,
                                   device="cpu", num_partitions=world)
        start = sess.prepare(_share(batches[0], rank, world))
        if start == 0:
            _load(sess, init, _share(batches[0], rank, world))
        losses = [float(sess.run("loss", feed_dict=_share(b, rank, world)))
                  for b in batches[start:stop]]
        out.append({"step": start, "losses": losses,
                    "params": _flat_np(sess.gather_params()),
                    "placements": dict(sess.engine.plan.placements)})
        sess.close()
    return out


def ckpt_bert_tp(rank, world, jobs, batches):
    """``ckpt_toy`` for BERT tiny with tensor parallelism (the fused
    ``wqkv`` column-parallel in 3 blocks, the MLP row-parallel; the batch
    on 'repl'), fp32, its own AdamW: per job the restored step, the
    losses and the gathered parameters."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import bert

    cfg = bert.tiny_config(num_heads=4, tensor_parallel=True,
                           compute_dtype=torch.float32)
    out = []
    for ckpt_dir, every, stop in jobs:
        sess, *_ = pt.parallel_run(
            bert.build_model(cfg), parallax_config=pt.Config(
                run_option="HYBRID", ckpt_config=pt.CheckPointConfig(
                    ckpt_dir=ckpt_dir, save_ckpt_steps=every)),
            device="cpu", num_partitions=world, seed=3)
        start = sess.prepare(_row_share(batches[0], sess.mesh))
        losses = [float(sess.run("loss",
                                 feed_dict=_row_share(b, sess.mesh)))
                  for b in batches[start:stop]]
        out.append({"step": start, "losses": losses,
                    "params": _flat_np(sess.gather_params()),
                    "placements": dict(sess.engine.plan.placements)})
        sess.close()
    return out


# -- pipeline parallelism and cross-rank BatchNorm (tests/test_torch_pipeline
# .py) ------------------------------------------------------------------------


def _pipe_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _pipe_loss(head, out, y_mb):
    return ((out @ head["wout"] - y_mb) ** 2).mean()


def pipe_ops(rank, world, cases):
    """Each case (name, mesh shape, V, M, w [S*V, D, D] and b [S*V, D]
    device-major, x [B, D], y, wout, cot): this rank's GPipe output and
    the gradients of sum(out * cot) (its stage rows and its repl row's
    x), and its 1F1B loss and gradients; the mesh it built and the
    collectives of one GPipe forward."""
    from parallax_tpu_torch.core import mesh as mesh_lib
    from parallax_tpu_torch.ops import collectives, pipeline as pp

    out = {}
    for name, shape, V, M, w, b, x, y, wout, cot in cases:
        if int(np.prod(shape)) != world:
            continue
        mesh = mesh_lib.build_mesh("cpu", shape=shape)
        r = mesh.coords[0]
        n = x.shape[0] // mesh.repl
        rows = slice(r * n, (r + 1) * n)
        loc = pp.stage_rows({"w": torch.tensor(w), "b": torch.tensor(b)},
                            mesh, V)
        loc = {k: v.clone().requires_grad_(True) for k, v in loc.items()}
        xr = torch.tensor(x[rows]).requires_grad_(True)
        with collectives.count_scope() as counts:
            y_out = pp.pipeline_apply(_pipe_stage, loc, xr, mesh, M, V)
        (y_out * torch.tensor(cot[rows])).sum().backward()
        loss, (gs, gh, gx) = pp.pipeline_value_and_grad(
            _pipe_stage, _pipe_loss, {k: v.detach() for k, v in loc.items()},
            xr.detach(), torch.tensor(y[rows]), mesh, M,
            head_params={"wout": torch.tensor(wout)}, virtual_stages=V)
        out[name] = {
            "coords": (r, mesh.coords[1], mesh.pipe_index),
            "axes": mesh.axis_names, "shape": mesh.shape,
            "stage": (mesh_lib.pipeline_stage_count(mesh),
                      mesh_lib.pipeline_index(mesh)),
            "out": _np(y_out), "gw": _np(loc["w"].grad),
            "gb": _np(loc["b"].grad), "gx": _np(xr.grad),
            "counts": dict(counts), "loss": float(loss),
            "g1w": _np(gs["w"]), "g1b": _np(gs["b"]),
            "g1head": _np(gh["wout"]), "g1x": _np(gx)}
    return out


def pipe_models(rank, world, runs):
    """Each run: (name, config kwargs, mesh shape, SGD learning rate or
    None, whole initial params (a JAX tree), batches): the long-context
    LM in pipeline mode under HYBRID on this mesh, each rank fed its repl
    row's rows: losses, tokens, the gathered parameters, the local shapes
    and the plan."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch import weights
    from parallax_tpu_torch.core import optim
    from parallax_tpu_torch.core.classify import flatten
    from parallax_tpu_torch.models import long_context as tlc

    out = {}
    for name, cfg_kw, shape, sgd, init, batches in runs:
        if shape[0] * shape[1] != world:
            continue
        cfg = tlc.tiny_config(compute_dtype=torch.float32,
                              parallelism="pipeline", **cfg_kw)
        model = tlc.build_model(cfg)
        if sgd is not None:
            model.optimizer = optim.sgd(sgd)
        sess, *_ = pt.parallel_run(
            model, parallax_config=pt.Config(run_option="HYBRID"),
            device="cpu", num_partitions=shape[1])
        mesh = sess.mesh
        sess.prepare(_row_share(batches[0], mesh))
        mine = dict(flatten(weights.long_context_params_from_jax(
            init, cfg, "cpu", engine=sess.engine)))
        with torch.no_grad():
            for path, leaf in flatten(sess.state.params):
                leaf.copy_(mine[path])
        losses, tokens = [], []
        for b in batches:
            loss, tok = sess.run(["loss", "tokens"],
                                 feed_dict=_row_share(b, mesh))
            losses.append(float(loss))
            tokens.append(float(tok))
        out[name] = {
            "mesh": (mesh.repl, mesh.shard, mesh.coords),
            "losses": losses, "tokens": tokens,
            "params": _flat_np(sess.gather_params()),
            "local_shapes": {p: tuple(v.shape) for p, v in
                             _flat_np(sess.state.params).items()},
            "placements": dict(sess.engine.plan.placements),
            "layout": sess.engine.batch_layout}
        sess.close()
    return out


def cnn_bn(rank, world, init, batches):
    """A small ResNet (stage sizes 1, 1, 1, 1; 8 filters; 10 classes; fp32)
    under AR, each rank fed its share of every batch, from the whole
    initial ``{"params", "batch_stats"}`` (a JAX tree): losses, accuracy,
    the smallest |pre-activation| of every ReLU, and the parameters,
    statistics and momentum after."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core.classify import flatten
    from parallax_tpu_torch.models import cnn, resnet
    from parallax_tpu_torch.weights import cnn_params_from_jax

    module = resnet.ResNet(stage_sizes=[1, 1, 1, 1], num_filters=8,
                           dtype=torch.float32, num_classes=10)
    sess, *_ = pt.parallel_run(cnn.module_model(module, 32),
                               parallax_config=pt.Config(run_option="AR"),
                               device="cpu", num_partitions=1)
    sess.prepare(_share(batches[0], rank, world))
    params, state = cnn_params_from_jax(init, module, 10, 32, "cpu")
    with torch.no_grad():
        for tree, new in ((sess.state.params, params),
                          (sess.state.model_state, state)):
            new = dict(flatten(new))
            for path, leaf in flatten(tree):
                leaf.copy_(new[path])
    margins = []
    relu_ = torch.Tensor.relu_

    def recording(t):
        if t.device.type != "meta":
            margins.append(float(t.detach().abs().min()))
        return relu_(t)

    torch.Tensor.relu_ = recording
    try:
        outs = [[float(v) for v in sess.run(
            ["loss", "accuracy"], feed_dict=_share(b, rank, world))]
            for b in batches]
    finally:
        torch.Tensor.relu_ = relu_
    res = {"outs": outs, "margin": min(margins),
           "params": {p: _np(t.permute(2, 3, 1, 0) if t.dim() == 4 else t)
                      for p, t in flatten(sess.state.params)},
           "stats": _flat_np(sess.state.model_state),
           "trace": {p: _np(t.permute(2, 3, 1, 0) if t.dim() == 4 else t)
                     for p, t in flatten(sess.state.opt_state[1][0])}}
    sess.close()
    return res


def ckpt_pipe(rank, world, jobs, cfg_kw, batches):
    """``ckpt_toy`` for the long-context LM in pipeline mode (fp32, its own
    clip + Adam, seed 3; the batch on 'repl'): per job the restored step,
    the losses, the gathered parameters and the plan."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import long_context as tlc

    cfg = tlc.tiny_config(compute_dtype=torch.float32,
                          parallelism="pipeline", **cfg_kw)
    out = []
    for ckpt_dir, every, stop in jobs:
        sess, *_ = pt.parallel_run(
            tlc.build_model(cfg), parallax_config=pt.Config(
                run_option="HYBRID", ckpt_config=pt.CheckPointConfig(
                    ckpt_dir=ckpt_dir, save_ckpt_steps=every)),
            device="cpu", num_partitions=world, seed=3)
        start = sess.prepare(_row_share(batches[0], sess.mesh))
        losses = [float(sess.run("loss",
                                 feed_dict=_row_share(b, sess.mesh)))
                  for b in batches[start:stop]]
        out.append({"step": start, "losses": losses,
                    "params": _flat_np(sess.gather_params()),
                    "placements": dict(sess.engine.plan.placements)})
        sess.close()
    return out


def pipe_all(rank, world, ops_cases, model_runs, bn=None):
    """``pipe_ops``, ``pipe_models`` and (given ``(init, batches)``)
    ``cnn_bn`` in one group of ranks."""
    out = {"ops": pipe_ops(rank, world, ops_cases),
           "models": pipe_models(rank, world, model_runs)}
    if bn is not None:
        out["bn"] = cnn_bn(rank, world, *bn)
    return out


# -- observability (obs/aggregate.py) -----------------------------------------


def obs_aggregate(rank, world, means):
    """The straggler report on ``world`` ranks: a timeline whose step
    walls are ``means[rank]`` (ms) gathered by
    ``aggregate_host_step_times``, then a toy session's own
    ``aggregate_host_steps`` after three steps."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.obs import aggregate
    from parallax_tpu_torch.obs.metrics import MetricsRegistry
    from parallax_tpu_torch.obs.timeline import StepTimeline

    tl = StepTimeline(MetricsRegistry())
    for s, m in enumerate(means[rank]):
        tl.record_step(s, 0.0, m * 1e-3, dispatch_s=m * 1e-3)
    report = aggregate.aggregate_host_step_times(tl.local_stats())
    sess, *_ = pt.parallel_run(toy_model(), device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = {"ids": rng.integers(0, 32, (4 * world, 3)),
                 "y": rng.standard_normal((4 * world, 3, 4)).astype(
                     np.float32)}
        sess.run("loss", feed_dict=_share(batch, rank, world))
    session_report = sess.aggregate_host_steps()
    sess.close()
    return {"timeline": report, "session": session_report}


# -- the mesh auto-tuner (tune/) -------------------------------------------------


def tune_lm1b(rank, world, cfg_kw, tune_kw, init, batches, candidates,
              script):
    """Tiny LM1B (HYBRID, slices) planned by the mesh search, its trials
    timed by ``script[rank]`` (one time a search step) in place of the
    clock: the plan each step ran on, the losses, the decision record,
    the probe's cost inputs and the parameters after the steps."""
    import dataclasses

    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import lm1b as tlm1b

    _fake_candidates(candidates)
    cfg = tlm1b.tiny_config(compute_dtype=torch.float32, lstm_impl="kernel",
                            **cfg_kw)
    sess, *_ = pt.parallel_run(
        tlm1b.build_model(cfg), parallax_config=pt.Config(
            run_option="HYBRID", sparse_grad_mode="slices",
            tune_config=pt.TuneConfig(**tune_kw)),
        device="cpu", num_partitions=4)
    times = iter(script[rank])
    record = sess._record_search_time
    sess._record_search_time = lambda dt: record(next(times))
    _load(sess, init, _share(batches[0], rank, world))
    inputs = dataclasses.asdict(sess._search._inputs)
    plans, losses = [], []
    for b in batches:
        plans.append(sess.plan.describe())
        losses.append(float(sess.run("loss", feed_dict=_share(b, rank,
                                                               world))))
    summary = dict(sess.tune_summary())
    summary.pop("search_seconds")
    out = {"plans": plans, "losses": losses, "summary": summary,
           "inputs": inputs, "final_plan": sess.plan.describe(),
           "mesh": (sess.mesh.repl, sess.mesh.shard),
           "params": _flat_np(sess.gather_params()),
           "engines": len(sess._engine_cache._engines)}
    sess.close()
    return out


# -- the engine's layouts (tests/test_torch_layouts.py) -----------------------


def spec_share(x, entries, coords, shape):
    """This rank's share of the whole feed ``x`` under the spec
    ``entries`` (None: the default, dim 0 over ('repl', 'shard')), as the
    JAX mesh's device ``coords`` of a ``shape`` mesh holds it: each split
    dim cut into the product of its axes' sizes, the first axis major."""
    if entries is None:
        entries = (("repl", "shard"),)
    size = {"repl": shape[0], "shard": shape[1]}
    at = {"repl": coords[0], "shard": coords[1]}
    for dim, e in enumerate(entries):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        n, i = 1, 0
        for a in axes:
            n *= size[a]
            i = i * size[a] + at[a]
        k = x.shape[dim] // n
        x = np.take(x, np.arange(i * k, (i + 1) * k), axis=dim)
    return x


def toy3_model(lr=0.1):
    """The toy model with a 3-d projection ``proj/w`` [D, K, H] summed
    over K (a middle dim to split)."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core import optim
    from parallax_tpu_torch.ops import collectives, embedding

    V, D, K, H = 32, 8, 4, 4

    def init_fn(gen, device):
        return {"emb": torch.randn((V, D), generator=gen, device=device),
                "proj": {"w": torch.randn((D, K, H), generator=gen,
                                          device=device)}}

    def loss_fn(params, batch):
        rows = embedding.embedding_lookup(params["emb"], batch["ids"])
        h = torch.einsum("bd,dkh->bh", rows, params["proj"]["w"])
        loss = collectives.global_mean((h - batch["y"]) ** 2)
        return loss, {"h_norm": collectives.global_mean(h ** 2)}

    return pt.Model(init_fn, loss_fn, optimizer=optim.sgd(lr))


def _layout_model(family, cfg_kw, candidates):
    """(model, whole-params converter, fetches) of one family."""
    from parallax_tpu_torch import weights
    from parallax_tpu_torch.models import bert as tbert, lm1b as tlm1b
    if family == "toy":
        return toy_model(), _to_torch, ["loss", "h_norm"]
    if family == "toy3":
        return toy3_model(), _to_torch, ["loss", "h_norm"]
    if family == "lm1b":
        _fake_candidates(candidates)
        cfg = tlm1b.tiny_config(compute_dtype=torch.float32,
                                lstm_impl="kernel", **cfg_kw)
        return tlm1b.build_model(cfg), _to_torch, ["loss", "words"]
    if family == "moe":
        from parallax_tpu_torch.models import moe_lm
        cfg = moe_lm.tiny_config(compute_dtype=torch.float32, **cfg_kw)
        return (moe_lm.build_model(cfg),
                lambda init: weights.moe_lm_params_from_jax(init, cfg,
                                                            "cpu"),
                ["loss", "lm_loss", "aux_loss", "moe_dropped"])
    cfg = tbert.tiny_config(compute_dtype=torch.float32, **cfg_kw)
    return (tbert.build_model(cfg),
            lambda init: weights.bert_params_from_jax(init, cfg, "cpu"),
            ["loss"])


def layout_models(rank, world, runs):
    """Each run: (name, family, model config kwargs, Config kwargs,
    num_partitions, feed specs {feed: entries} (None: the model's own),
    param specs
    {pattern: entries}, whole initial params, batches, sampled
    candidates): the fetches a step, the gathered parameters, the plan,
    the layout and, with a numerics interval, each step's stats."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core import mesh as mesh_lib
    from parallax_tpu_torch.core.classify import flatten
    from parallax_tpu_torch import weights

    out = {}
    for (name, family, cfg_kw, config_kw, parts, feeds, pspecs, init,
         batches, candidates) in runs:
        model, whole_of, fetches = _layout_model(family, cfg_kw,
                                                 candidates)
        if feeds is not None:
            model.batch_specs = {k: mesh_lib.P(*e) for k, e in feeds.items()}
        specs = {k: tuple(v) for k, v in model.batch_specs.items()}
        model.param_specs.update({k: mesh_lib.P(*e)
                                  for k, e in pspecs.items()})
        numerics = config_kw.get("numerics_interval", 0) > 0
        if numerics:
            fetches = fetches + ["numerics"]
        sess, *_ = pt.parallel_run(
            model, parallax_config=pt.Config(**config_kw), device="cpu",
            num_partitions=parts)
        mesh = sess.mesh
        shape = (mesh.repl, mesh.shard)

        def share(b):
            return {k: spec_share(v, specs.get(k), mesh.coords, shape)
                    for k, v in b.items()}

        sess.prepare(share(batches[0]))
        mine = dict(flatten(weights.rank_shard(whole_of(init),
                                               sess.engine)))
        with torch.no_grad():
            for path, leaf in flatten(sess.state.params):
                leaf.copy_(mine[path])
        steps, last = [], None
        for i, b in enumerate(batches):
            if numerics and i == len(batches) - 1:
                # copies: on the CPU the numpy views share the live
                # tensors the step updates in place
                last = {"before": {p: v.copy() for p, v in _flat_np(
                    sess.gather_params()).items()}}
            got = sess.run(fetches, feed_dict=share(b))
            row = {}
            for k, v in zip(fetches, got):
                if k == "numerics":
                    tree = v.result() if hasattr(v, "result") else v
                    row[k] = {p: {s: float(x) for s, x in stats.items()}
                              for p, stats in tree.items()
                              if isinstance(stats, dict)}
                else:
                    row[k] = float(v)
            steps.append(row)
        if last is not None:
            # the last step's own whole tensors: its stats' inputs
            eng = sess.engine
            grads = eng._last_grads
            last["after"] = _flat_np(sess.gather_params())
            with torch.no_grad():
                last["grads"] = {
                    p: (_np(eng.plan.whole(p, grads[p]) if p in eng.plan.split
                            else grads[p]) if p in grads
                        else np.zeros_like(w))
                    for p, w in last["after"].items()}
        out[name] = {"steps": steps, "last": last,
                     "params": _flat_np(sess.gather_params()),
                     "placements": dict(sess.engine.plan.placements),
                     "layout": sess.engine.batch_layout,
                     "local_shapes": {p: tuple(v.shape) for p, v in
                                      _flat_np(sess.state.params).items()}}
        sess.close()
    return out


# -- serving over the mesh ----------------------------------------------------


def serve_toy_model():
    """A model whose loss reads the served feed alone (``ids``), so the
    serving session can classify its parameters on that feed."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core import optim
    from parallax_tpu_torch.ops import collectives, embedding

    def init_fn(gen, device):
        return {"emb": torch.randn((32, 8), generator=gen, device=device),
                "proj": {"w": torch.randn((8, 4), generator=gen,
                                          device=device)}}

    def loss_fn(params, batch):
        h = embedding.embedding_lookup(params["emb"], batch["ids"]) \
            @ params["proj"]["w"]
        return collectives.global_mean(h ** 2)

    return pt.Model(init_fn, loss_fn, optimizer=optim.sgd(0.1))


def serve_toy_infer(params, batch):
    from parallax_tpu_torch.ops import embedding
    h = embedding.embedding_lookup(params["emb"], batch["ids"]) \
        @ params["proj"]["w"]
    return {"h": h, "n": h.sum(-1).sum(-1)}


def _submit_all(sess, feeds, caps=None, bursts=None):
    """Each request's result, submitted in ``bursts`` (lists of indices,
    each burst waited for before the next) or all at once."""
    bursts = bursts or [list(range(len(feeds)))]
    out = [None] * len(feeds)
    for burst in bursts:
        reqs = {i: (sess.submit(feeds[i], max_new_tokens=caps[i])
                    if caps is not None else sess.submit(feeds[i]))
                for i in burst}
        for i, r in reqs.items():
            out[i] = r.result(timeout=60)
    return out


class _StandInGraph:
    """Stands in for a captured graph (the CPU captures none): records
    whether ``close()`` released it."""

    released = False

    def release(self):
        self.released = True


def _plant_graphs(rank, sess):
    """Stand-in graphs where a card's session keeps its captured ones:
    the decode program's (a ``_Graphs`` on no params, which every call
    passes over, so a follower still replaying is not disturbed) and,
    on the leader whose batcher is idle, each one-shot signature's."""
    from parallax_tpu_torch.serve import adapters
    planted = []
    if sess._program is not None:
        g = adapters._Graphs(None, None, None)
        g.step = _StandInGraph()
        g.chunks = [_StandInGraph()]
        sess._program._graphs = g
        planted += [g.step, *g.chunks]
    elif rank == 0:
        for entry in sess._signatures.values():
            entry.graph = _StandInGraph()
            planted.append(entry.graph)
    return planted


def _serve_case(rank, sess, feeds, caps=None, bursts=None, rows=None):
    """The leader serves ``feeds``; a follower checks that it refuses a
    submit. Every rank closes; ``released`` says whether the close
    released the stand-in graphs planted before it."""
    res = {"rows": rows}
    if rank == 0:
        res["out"] = _submit_all(sess, feeds, caps, bursts)
        res["recompiles"] = sess.stats()["serve.recompiles"]
    else:
        try:
            sess.submit(feeds[0])
            res["submit"] = None
        except ValueError as e:
            res["submit"] = str(e)
    planted = _plant_graphs(rank, sess)
    sess.close()
    res["closed"] = True
    res["released"] = [g.released for g in planted]
    return res


def serve_mesh(rank, world, shape, oneshot, nmt_case, lm1b_cases,
               handoff=None, moe=None):
    """``ServeSession`` over the ``shape`` mesh: one-shot with a
    row-sharded table, NMT and LM1B decode with the plan's row-sharded
    tables (``model=``), and optionally ``session.serve()``'s handoff and
    the expert-placement refusal."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch import weights
    from parallax_tpu_torch.core import mesh as mesh_lib
    from parallax_tpu_torch.models import lm1b, moe_lm, nmt

    mesh = mesh_lib.build_mesh("cpu", shape=shape)
    out = {"coords": mesh.coords}

    def config(**sc):
        return pt.Config(serve_config=pt.ServeConfig(**sc))

    # one-shot: each rank its rows of emb, buckets split or whole
    sess = pt.ServeSession(
        serve_toy_infer, _to_torch(oneshot["init"]),
        example_feed={"ids": np.zeros((3,), np.int32)},
        model=serve_toy_model(), mesh=mesh,
        config=config(max_batch=8, max_wait_ms=50.0))
    split = {sig[0][1][0]: e.split for sig, e in sess._signatures.items()}
    res = _serve_case(rank, sess, [{"ids": i} for i in oneshot["ids"]],
                      bursts=oneshot["bursts"],
                      rows=tuple(sess._params["emb"].shape))
    res["split"] = split
    out["oneshot"] = res

    # NMT decode: emb row-sharded, out_proj dense
    cfg = nmt.tiny_config(**nmt_case["cfg"], compute_dtype=torch.float32)
    prog = pt.NMTDecodeProgram(cfg, **nmt_case["prog"], device="cpu")
    sess = pt.ServeSession(
        program=prog, params=weights.params_from_jax(
            nmt_case["params"], cfg, device="cpu"),
        model=nmt.build_model(cfg), mesh=mesh,
        config=config(max_batch=4, max_queue=64))
    out["nmt"] = _serve_case(rank, sess, [{"src": s}
                                          for s in nmt_case["srcs"]],
                             caps=nmt_case["caps"],
                             rows=tuple(sess._params["emb"].shape))

    # LM1B decode: the softmax table row-sharded, the argmax over ranks
    out["lm1b"] = []
    for case in lm1b_cases:
        cfg = lm1b.tiny_config(compute_dtype=torch.float32)
        prog = pt.LM1BDecodeProgram(cfg, max_src_len=8, max_len=8,
                                    device="cpu")
        sess = pt.ServeSession(
            program=prog, params=weights.lm1b_params_from_jax(
                case["params"], cfg, device="cpu"),
            model=lm1b.build_model(cfg), mesh=mesh,
            config=config(max_batch=4, max_queue=64))
        out["lm1b"].append(_serve_case(
            rank, sess, [{"ids": p} for p in case["prompts"]],
            caps=case["caps"],
            rows=tuple(sess._params["softmax_w"].shape)))

    if moe is not None:
        cfg = moe_lm.tiny_config(compute_dtype=torch.float32)
        params = moe_lm.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        prog = pt.MoeLMDecodeProgram(cfg, max_src_len=8, max_len=8,
                                     device="cpu")
        try:
            pt.ServeSession(program=prog, params=params,
                            model=moe_lm.build_model(cfg), mesh=mesh,
                            config=config(max_batch=4))
            out["moe"] = None
        except NotImplementedError as e:
            out["moe"] = str(e)

    if handoff is not None:
        out["handoff"] = _serve_handoff(rank, world, shape, handoff)
    return out


def _serve_handoff(rank, world, shape, case):
    """``ParallaxSession.serve()`` over the training mesh: the served
    tensors are the engine's own (no gather, no copy)."""
    import parallax_tpu_torch as pt
    sess, *_ = pt.parallel_run(
        toy_model(), parallax_config=pt.Config(
            run_option="HYBRID", serve_config=pt.ServeConfig(
                max_batch=4, max_wait_ms=20.0)),
        num_partitions=shape[1], device="cpu")
    _load(sess, case["init"], _share(case["batch"], rank, world))
    sess.run("loss", feed_dict=_share(case["batch"], rank, world))
    emb = sess.state.params["emb"]
    srv = sess.serve(serve_toy_infer,
                     example_feed={"ids": np.zeros((3,), np.int32)})
    same = srv._params["emb"] is emb \
        and srv._params["proj"]["w"] is sess.state.params["proj"]["w"]
    res = _serve_case(rank, srv, [{"ids": i} for i in case["ids"]],
                      rows=tuple(emb.shape))
    res["same"] = same
    whole = sess.gather_params()
    res["whole"] = {"emb": _np(whole["emb"]),
                    "w": _np(whole["proj"]["w"])}
    sess.close()
    return res
