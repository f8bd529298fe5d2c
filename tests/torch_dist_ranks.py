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
