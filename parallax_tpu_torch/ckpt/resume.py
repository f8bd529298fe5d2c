"""Restore entry point for eval flows and resharded restore
(``parallax_tpu/ckpt/resume.py``).

The manifest describes global arrays, so a restore is layout-agnostic:
whatever ranks and mesh saved a checkpoint, it restores onto the state
the caller builds, each rank taking its own pieces. With an example batch
the engine's plan is rebuilt (row shards, tensor-parallel shards,
``sparse_grad_mode="slices"``'s grouping); without one every leaf is
restored whole.
"""

from __future__ import annotations


def restore_train_state(ckpt_dir: str, model, seed: int = 0, mesh=None,
                        example_batch=None, config=None, device="cuda"):
    """Restore the latest verified checkpoint under ``ckpt_dir`` into a
    fresh ``TrainState`` of ``model``. Returns ``(state, step)``.

    With ``example_batch`` the state is the one ``Engine`` builds on
    ``mesh`` (default: the mesh of every rank of the initialised process
    group, or one rank) under ``config``, so it restores onto the live
    training layout, which may differ from the one that saved. Without it
    the parameters, the optimizer state over every parameter and the
    model state are restored whole. A ``sync=False`` checkpoint carries
    ``pending_grads`` a fresh state lacks: their shapes and dtypes are
    read from the manifest."""
    import torch

    from parallax_tpu_torch.ckpt import snapshot as snap_lib
    from parallax_tpu_torch.ckpt.store import CheckpointStore
    from parallax_tpu_torch.common.config import ParallaxConfig
    from parallax_tpu_torch.common.lib import resolve_device
    from parallax_tpu_torch.core import classify, mesh as mesh_lib
    from parallax_tpu_torch.core.engine import Engine, TrainState

    store = CheckpointStore(ckpt_dir, max_to_keep=None)
    latest = store.latest_step()
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    dev = resolve_device(mesh.device if mesh is not None else device)
    engine = None
    if example_batch is not None:
        cfg = config or ParallaxConfig()
        engine = Engine(model, mesh or mesh_lib.build_mesh(dev), cfg,
                        example_batch)
        state = engine.init_state(seed)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params, mstate = model.call_init(gen, dev)
        with torch.no_grad():
            opt_state = model.optimizer.init(dict(classify.flatten(params)))
        state = TrainState(step=0, params=params, opt_state=opt_state,
                           seed=seed, model_state=mstate)
    _extend_pending_grads(store, latest, state, dev)
    leaves = snap_lib.state_leaves(state, engine,
                                   optimizer=model.optimizer)
    out = store.restore_latest(leaves)
    if out is None:
        raise FileNotFoundError(
            f"no restorable checkpoint under {ckpt_dir} (all torn or "
            f"corrupt)")
    return state, out[1]


def _extend_pending_grads(store, step: int, state, device) -> None:
    """When the manifest carries ``pending_grads`` (a ``sync=False``
    checkpoint) and the state does not, give the state zeros of the saved
    shapes and dtypes, so the trees match."""
    import torch

    from parallax_tpu_torch.ckpt.snapshot import torch_dtype

    if state.pending_grads is not None:
        return
    manifest = store.read_manifest(step) or {}
    prefix = "pending_grads/"
    sub = {p[len(prefix):]: info
           for p, info in manifest.get("leaves", {}).items()
           if p.startswith(prefix)}
    if sub:
        state.pending_grads = {
            p: torch.zeros(tuple(info["shape"]),
                           dtype=torch_dtype(info["dtype"]), device=device)
            for p, info in sub.items()}
