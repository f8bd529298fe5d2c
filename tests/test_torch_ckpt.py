"""The port's checkpoints and recovery (``parallax_tpu_torch/ckpt``) held
to the JAX package's: the counterparts of ``tests/test_ckpt.py``'s store,
config, exact-resume, resharded-restore, recovery and preemption cases,
and beyond them

* the manifest's leaf names, shapes and dtypes equal to the JAX
  package's for LM1B (slices and dense), NMT, BERT, a small ResNet (with
  its model state), the long-context and MoE LMs, ``sync=False``
  (``pending_grads``), skip-thoughts, the LM1B full-softmax baseline and
  the long-context LM in pipeline mode (``blocks_stacked``, V 1 and 2);
  the ``rng`` leaf is JAX's ``PRNGKey(seed + 1)``;
* a JAX checkpoint restored into the port and a port checkpoint restored
  by the JAX session, each continued three steps by both packages, the
  losses within 1e-4 (LM1B tiny, slices, fp32; each step's sampled
  candidates are the JAX session's own, as in ``test_torch_train.py``);
* a resharded restore between two gloo ranks (mesh (1, 2)) and one rank,
  both ways, a tensor-parallel BERT's checkpoint (column blocks and row
  shards as global extents) continued on one rank, and a pipeline LM's
  (each rank's stage rows as its extent of the global ``[L, ...]``
  stack in storage order, V 1 and 2) continued on one rank;
* SIGTERM and the torn-manifest fault in subprocesses (a handler
  installed in a test would outlive it, and xdist workers do not run
  tests on a process's main thread).

States are kilobytes; no test asserts a time.
"""

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
import torch_dist_ranks as bodies
from parallax_tpu.ckpt import snapshot as jsnap
from parallax_tpu.ckpt.store import CheckpointStore as JStore
from parallax_tpu.models import bert as jbert
from parallax_tpu.models import cnn as jcnn
from parallax_tpu.models import lm1b as jlm1b
from parallax_tpu.models import long_context as jlc
from parallax_tpu.models import moe_lm as jmoe
from parallax_tpu.models import nmt as jnmt
from parallax_tpu.models import resnet as jresnet
from parallax_tpu.models import skip_thoughts as jst
from parallax_tpu.ops import sampled_softmax as jss
from parallax_tpu_torch import weights
from parallax_tpu_torch.ckpt import (CheckpointCorrupt, CheckpointHook,
                                     CheckpointStore, CheckpointTreeMismatch,
                                     RecoverySurrender, restore_train_state)
from parallax_tpu_torch.ckpt import hook as hook_mod
from parallax_tpu_torch.ckpt import snapshot as tsnap
from parallax_tpu_torch.models import bert as tbert
from parallax_tpu_torch.models import cnn as tcnn
from parallax_tpu_torch.models import lm1b as tlm1b
from parallax_tpu_torch.models import long_context as tlc
from parallax_tpu_torch.models import moe_lm as tmoe
from parallax_tpu_torch.models import nmt as tnmt
from parallax_tpu_torch.models import resnet as tresnet
from parallax_tpu_torch.models import simple as tsimple
from parallax_tpu_torch.models import skip_thoughts as tst
from parallax_tpu_torch.ops import sampled_softmax as tss
from test_torch_dist import run_ranks

ROOT = Path(__file__).resolve().parent.parent


def batch_for(i, nan=False):
    b = tsimple.make_batch(np.random.default_rng(4000 + i), 32)
    if nan:
        b["x"] = b["x"] * np.nan
    return b


def _cfg(ckpt_dir=None, every=3, **ckpt_kw):
    return tparallax.Config(
        run_option="AR", ckpt_config=tparallax.CheckPointConfig(
            ckpt_dir=ckpt_dir, save_ckpt_steps=every, **ckpt_kw))


def _session(cfg):
    sess, *_ = tparallax.parallel_run(tsimple.build_model(0.1),
                                      parallax_config=cfg, device="cpu")
    return sess


def _train(cfg, n, start=0, losses=None):
    sess = _session(cfg)
    got = sess.prepare(batch_for(0))
    assert got == start
    out = [float(sess.run("loss", feed_dict=batch_for(i)))
           for i in range(got, n)]
    if losses is not None:
        losses.extend(out)
    return sess


# -- store units --------------------------------------------------------------


def _state():
    """Replicated, bf16, scalar and a two-piece (row-split) leaf."""
    table = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    leaves = tsnap.tree_leaves({
        "dense": torch.linspace(0, 1, 12).reshape(3, 4),
        "bf16": torch.arange(6).to(torch.bfloat16),
        "step": np.asarray(7, np.int32)})
    leaves.append(tsnap.Leaf(
        "table", table, (8, 8), "float32",
        [(((0, 4), (0, 8)), (slice(0, 4), slice(None))),
         (((4, 8), (0, 8)), (slice(4, 8), slice(None)))]))
    return leaves


def _zeros_like(leaves):
    out = []
    for leaf in leaves:
        v = leaf.value
        z = torch.zeros_like(v) if isinstance(v, torch.Tensor) \
            else np.zeros_like(v)
        out.append(tsnap.Leaf(leaf.name, z, leaf.shape, leaf.dtype,
                              leaf.pieces))
    return out


def _values(leaves):
    return {leaf.name: (leaf.value.clone() if isinstance(
        leaf.value, torch.Tensor) else np.array(leaf.value))
        for leaf in leaves}


class TestStore:
    def test_roundtrip_bit_identical(self, tmp_path):
        state = _state()
        store = CheckpointStore(str(tmp_path / "s"))
        store.save(5, state, extras={"cursor": 5})
        into = _zeros_like(state)
        _, step, info = store.restore_latest(into)
        assert step == 5 and not info["fallbacks"]
        assert store.restore_extras(5) == {"cursor": 5}
        want, got = _values(state), _values(into)
        for k in want:
            if isinstance(want[k], torch.Tensor):
                assert got[k].dtype == want[k].dtype
                assert torch.equal(got[k], want[k]), k
            else:
                np.testing.assert_array_equal(got[k], want[k])
        m = store.read_manifest(5)
        assert m["leaves"]["bf16"]["dtype"] == "bfloat16"
        assert len(m["leaves"]["table"]["shards"]) == 2

    def test_jax_store_reads_port_checkpoint_and_back(self, tmp_path):
        """The JAX package's store restores the port's checkpoint (bf16
        included) and the port restores the JAX package's."""
        state = _state()
        CheckpointStore(str(tmp_path / "p")).save(3, state)
        tmpl = {"dense": np.zeros((3, 4), np.float32),
                "bf16": np.zeros((6,), jnp.bfloat16),
                "step": np.zeros((), np.int32),
                "table": np.zeros((8, 8), np.float32)}
        got, step, _ = JStore(str(tmp_path / "p")).restore_latest(tmpl)
        assert step == 3
        np.testing.assert_array_equal(got["table"],
                                      np.arange(64).reshape(8, 8))
        np.testing.assert_array_equal(
            np.asarray(got["bf16"], np.float32), np.arange(6))
        JStore(str(tmp_path / "j")).save(4, got)
        into = _zeros_like(state)
        assert CheckpointStore(str(tmp_path / "j")).restore_latest(
            into)[1] == 4
        for k, v in _values(state).items():
            g = _values(into)[k]
            assert (torch.equal(g, v) if isinstance(v, torch.Tensor)
                    else np.array_equal(g, v)), k

    def test_truncated_shard_falls_back(self, tmp_path):
        state = _state()
        store = CheckpointStore(str(tmp_path / "s"))
        store.save(2, state)
        store.save(4, state)
        f = glob.glob(str(tmp_path / "s" / "4" / "shards_*.npz"))[0]
        with open(f, "r+b") as fh:
            fh.truncate(16)
        _, step, info = store.restore_latest(_zeros_like(state))
        assert step == 2
        assert [k["step"] for k in info["fallbacks"]] == [4]

    def test_checksum_mismatch_falls_back(self, tmp_path):
        state = _state()
        store = CheckpointStore(str(tmp_path / "s"))
        store.save(2, state)
        store.save(4, state)
        mpath = str(tmp_path / "s" / "4" / "manifest.json")
        m = json.load(open(mpath))
        row = m["leaves"]["table"]["shards"][0]
        row["crc32"] = (row["crc32"] + 1) & 0xFFFFFFFF
        json.dump(m, open(mpath, "w"))
        into = _zeros_like(state)
        with pytest.raises(CheckpointCorrupt):
            store.restore(4, into)
        # verified before anything is written
        assert not _values(into)["dense"].any()
        _, step, info = store.restore_latest(into)
        assert step == 2 and info["fallbacks"]

    def test_missing_manifest_is_torn(self, tmp_path):
        state = _state()
        store = CheckpointStore(str(tmp_path / "s"))
        store.save(2, state)
        store.save(4, state)
        os.remove(str(tmp_path / "s" / "4" / "manifest.json"))
        assert store.complete_steps() == [2]
        _, step, info = store.restore_latest(_zeros_like(state))
        assert step == 2 and info["torn_steps"] == [4]

    def test_mid_write_crash_leaves_restorable_previous(self, tmp_path):
        state = _state()
        store = CheckpointStore(str(tmp_path / "s"))
        store.save(2, state)

        def die(phase):
            if phase == "before_manifest":
                raise OSError("simulated crash mid-commit")

        store._fault_hook = die
        with pytest.raises(OSError):
            store.save(4, state)
        store._fault_hook = None
        assert store.complete_steps() == [2]
        into = _zeros_like(state)
        assert store.restore_latest(into)[1] == 2
        assert torch.equal(_values(into)["table"], _values(state)["table"])

    def test_template_shape_mismatch_refuses(self, tmp_path):
        store = CheckpointStore(str(tmp_path / "s"))
        store.save(1, {"dense": torch.zeros(3, 4)})
        with pytest.raises(CheckpointTreeMismatch, match="shape"):
            store.restore(1, {"dense": torch.zeros(5, 4)})

    def test_tree_mismatch_is_two_way_and_propagates(self, tmp_path):
        tree = {"a": torch.ones(2), "b": torch.ones(3)}
        store = CheckpointStore(str(tmp_path / "s"))
        store.save(2, tree)
        store.save(4, tree)
        with pytest.raises(CheckpointTreeMismatch,
                           match="absent from template"):
            store.restore(4, {"a": torch.ones(2)})
        with pytest.raises(CheckpointTreeMismatch):
            store.restore_latest({"a": torch.ones(2)})
        with pytest.raises(CheckpointTreeMismatch,
                           match="missing from checkpoint"):
            store.restore(4, dict(tree, extra=torch.zeros(2)))

    def test_dtype_mismatch_refuses(self, tmp_path):
        store = CheckpointStore(str(tmp_path / "s"))
        store.save(1, {"w": torch.zeros(6, dtype=torch.bfloat16)})
        with pytest.raises(CheckpointTreeMismatch, match="dtype"):
            store.restore(1, {"w": torch.zeros(6)})

    def test_resave_clears_stale_process_shards(self, tmp_path):
        state = _state()
        store = CheckpointStore(str(tmp_path / "s"))
        store.save(8, state)
        d = str(tmp_path / "s" / "8")
        shutil.copy(os.path.join(d, "shards_0.npz"),
                    os.path.join(d, "shards_1.npz"))
        shutil.copy(os.path.join(d, "shards_0.json"),
                    os.path.join(d, "shards_1.json"))
        store.save(8, state)
        m = json.load(open(os.path.join(d, "manifest.json")))
        assert {row["file"] for e in m["leaves"].values()
                for row in e["shards"]} == {"shards_0.npz"}

    def test_save_refuses_foreign_step_dir(self, tmp_path):
        store = CheckpointStore(str(tmp_path / "s"))
        legacy = tmp_path / "s" / "3"
        legacy.mkdir(parents=True)
        (legacy / "_CHECKPOINT_METADATA").write_text("{}")
        with pytest.raises(CheckpointCorrupt, match="pre-upgrade"):
            store.save(3, _state())
        assert (legacy / "_CHECKPOINT_METADATA").exists()

    def test_foreign_layout_never_deleted(self, tmp_path, caplog):
        import logging
        state = _state()
        store = CheckpointStore(str(tmp_path / "s"), max_to_keep=1)
        legacy = tmp_path / "s" / "1"
        legacy.mkdir()
        (legacy / "_CHECKPOINT_METADATA").write_text("{}")
        with caplog.at_level(logging.ERROR):
            store.save(5, state)
            store.save(6, state)
            out = store.restore_latest(_zeros_like(state))
        assert out is not None and out[1] == 6
        assert legacy.is_dir()
        assert any("UNRECOGNIZED layout" in r.message
                   for r in caplog.records)

    def test_gc_retention_and_torn_cleanup(self, tmp_path):
        state = _state()
        store = CheckpointStore(str(tmp_path / "s"), max_to_keep=2)
        for s in (1, 2, 3):
            store.save(s, state)
        assert store.complete_steps() == [2, 3]
        os.makedirs(str(tmp_path / "s" / "0"))
        store.gc()
        assert not os.path.isdir(str(tmp_path / "s" / "0"))
        store2 = CheckpointStore(str(tmp_path / "s2"), max_to_keep=None)
        for s in (1, 2, 3, 4):
            store2.save(s, state)
        assert store2.complete_steps() == [1, 2, 3, 4]


# -- config and hook ----------------------------------------------------------


class TestConfigValidation:
    def test_misspelled_async_knob_raises(self):
        with pytest.raises(TypeError):
            tparallax.CheckPointConfig(asycn_save=True)

    def test_async_save_must_be_bool(self):
        with pytest.raises(ValueError, match="async_save"):
            tparallax.CheckPointConfig(async_save="yes")

    def test_trigger_and_retention_validation(self):
        with pytest.raises(ValueError, match="save_ckpt_steps"):
            tparallax.CheckPointConfig(save_ckpt_steps=0)
        with pytest.raises(ValueError, match="save_ckpt_secs"):
            tparallax.CheckPointConfig(save_ckpt_secs=0)
        with pytest.raises(ValueError, match="max_to_keep"):
            tparallax.CheckPointConfig(max_to_keep=0)
        assert tparallax.CheckPointConfig(max_to_keep=None) \
            .max_to_keep is None

    def test_recovery_config_validation(self):
        with pytest.raises(ValueError, match="snapshot_every_steps"):
            tparallax.RecoveryConfig(enabled=True, snapshot_every_steps=0)
        with pytest.raises(ValueError, match="max_retries"):
            tparallax.RecoveryConfig(max_retries=0)

    def test_recovery_auto_enables_monitor_health(self):
        cfg = tparallax.Config(
            recovery_config=tparallax.RecoveryConfig(enabled=True))
        assert cfg.monitor_health
        assert not tparallax.Config().monitor_health

    def test_async_save_honored(self, tmp_path):
        hook = CheckpointHook(tparallax.CheckPointConfig(
            ckpt_dir=str(tmp_path / "c"), save_ckpt_steps=1,
            async_save=True), worker_id=0)
        assert hook.maybe_save(1, {"w": torch.ones(4)})
        assert hook.maybe_save(2, lambda: {"w": torch.ones(4) * 2})
        hook.close()
        assert CheckpointStore(str(tmp_path / "c")).complete_steps() \
            == [1, 2]
        assert hook.stats()["last_saved_step"] == 2
        into = {"w": torch.zeros(4)}
        CheckpointStore(str(tmp_path / "c")).restore(2, into)
        assert torch.equal(into["w"], torch.full((4,), 2.0))

    def test_save_now_dedupes_current_step(self, tmp_path):
        hook = CheckpointHook(tparallax.CheckPointConfig(
            ckpt_dir=str(tmp_path / "c"), save_ckpt_steps=1), worker_id=0)
        state = {"w": torch.ones(4)}
        assert hook.save_now(3, state, reason="preemption") is not None
        assert hook.save_now(3, state, reason="preemption") is None
        hook.close()

    def test_save_now_refuses_multiprocess(self, tmp_path, monkeypatch):
        hook = CheckpointHook(tparallax.CheckPointConfig(
            ckpt_dir=str(tmp_path / "c"), save_ckpt_steps=1), worker_id=0)
        monkeypatch.setattr(hook_mod, "process_count", lambda: 2)
        assert hook.save_now(3, {"w": torch.ones(4)}) is None
        monkeypatch.undo()
        hook.close()
        assert CheckpointStore(str(tmp_path / "c")).complete_steps() == []

    @pytest.mark.parametrize("backend,device",
                             [("gloo", "cpu"), ("nccl", "cuda:0")])
    def test_seconds_trigger_broadcast_lies_on_the_group_device(
            self, tmp_path, monkeypatch, backend, device):
        """On several ranks rank 0's seconds trigger is broadcast every
        ``SECS_BROADCAST_EVERY`` steps; NCCL refuses a host tensor, so
        under NCCL the flag lies on the current card."""
        hook = CheckpointHook(tparallax.CheckPointConfig(
            ckpt_dir=str(tmp_path / "c"), save_ckpt_secs=1e9), worker_id=0)
        real_tensor = torch.tensor
        asked, sent = [], []

        def tensor(data, dtype=None, device=None):
            asked.append(device)
            return real_tensor(data, dtype=dtype)

        def broadcast(flag, src):
            sent.append(src)
            flag.fill_(1)                 # rank 0 finds a save due

        monkeypatch.setattr(hook_mod, "process_count", lambda: 2)
        monkeypatch.setattr(torch.distributed, "get_backend",
                            lambda *a: backend)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch, "tensor", tensor)
        monkeypatch.setattr(torch.distributed, "broadcast", broadcast)
        every = hook.SECS_BROADCAST_EVERY
        due = [hook._decide_due(every), hook._decide_due(every + 1)]
        monkeypatch.undo()
        hook.close()
        assert due == [True, False]
        assert asked == [torch.device(device)] and sent == [0]

    def test_ckpt_dir_without_trigger_defaults_to_600s(self, tmp_path):
        hook = CheckpointHook(tparallax.CheckPointConfig(
            ckpt_dir=str(tmp_path / "c")), worker_id=0)
        assert hook._config.save_ckpt_secs == 600.0
        assert not hook.maybe_save(1, {"w": torch.ones(1)})


# -- exact resume -------------------------------------------------------------


class TestExactResume:
    def test_resume_is_bit_identical(self, tmp_path):
        N = 8
        ref = []
        _train(_cfg(str(tmp_path / "unused")), N, losses=ref).close()
        ck = str(tmp_path / "ck")
        sess = _train(_cfg(ck), 5)      # committed at step 3
        del sess                         # a crash: no close, no final save
        sess2 = _session(_cfg(ck))
        start = sess2.prepare(batch_for(0))
        assert start == 3 and sess2.data_cursor == 3
        feed = (batch_for(i) for i in range(N))
        got = [float(v) for v in sess2.run_iter(feed, fetches="loss",
                                                skip="auto")]
        assert got == ref[start:]
        sess2.close()

    def test_extras_carry_the_jax_key_set(self, tmp_path):
        ck = str(tmp_path / "ck")
        _train(_cfg(ck, every=2), 4).close()
        extras = CheckpointStore(ck).restore_extras(4)
        assert set(extras) == {"data_cursor", "host_step", "anomaly",
                               "health", "recovery", "ops"}
        assert extras["data_cursor"] == extras["host_step"] == 4

    def test_torn_newest_falls_back(self, tmp_path, caplog):
        import logging
        ck = str(tmp_path / "ck")
        _train(_cfg(ck, every=2), 4).close()
        f = glob.glob(os.path.join(ck, "4", "shards_*.npz"))[0]
        with open(f, "r+b") as fh:
            fh.truncate(10)
        sess = _session(_cfg(ck, every=2))
        with caplog.at_level(logging.WARNING):
            assert sess.prepare(batch_for(0)) == 2
        assert any("FAILED verification" in r.message
                   or "FELL BACK" in r.message for r in caplog.records)
        assert sess._ckpt.last_restore_info["fallbacks"]
        sess.close()

    @pytest.mark.parametrize("async_save", [False, True])
    def test_lm1b_token_stream_resume_is_bit_identical(self, tmp_path,
                                                       async_save):
        """LM1B tiny (slices, dropout on) fed by a native TokenDataset:
        10 steps saving every 5, the step-10 checkpoint removed, then a
        new session resumes at step 5 and skips 5 batches of a new
        dataset: steps 5-9 give the same losses bit for bit."""
        from parallax_tpu_torch.data import TokenDataset, write_token_file
        tokens = str(tmp_path / "tokens.bin")
        write_token_file(tokens,
                         np.random.default_rng(0).zipf(1.3, 6000) % 1000)
        ck = str(tmp_path / "ck")
        cfg = tlm1b.tiny_config(sparse_grad_mode="slices",
                                compute_dtype=torch.float32,
                                lstm_impl="kernel")

        def session():
            sess, *_ = tparallax.parallel_run(
                tlm1b.build_model(cfg), parallax_config=tparallax.Config(
                    run_option="HYBRID", sparse_grad_mode="slices",
                    ckpt_config=tparallax.CheckPointConfig(
                        ckpt_dir=ck, save_ckpt_steps=5,
                        async_save=async_save, max_to_keep=2)),
                seed=4, device="cpu")
            return sess

        ds = TokenDataset(tokens, 8, 6, seed=9)
        a = session()
        la = [float(x) for x in a.run_iter(
            (ds.next_batch() for _ in range(10)), fetches="loss")]
        a.close()
        ds.close()
        assert CheckpointStore(ck).complete_steps() == [5, 10]
        shutil.rmtree(os.path.join(ck, "10"))
        ds = TokenDataset(tokens, 8, 6, seed=9)
        b = session()
        assert b.prepare(ds.next_batch()) == 5
        assert b.data_cursor == 5
        ds.close()
        ds = TokenDataset(tokens, 8, 6, seed=9)
        lb = [float(x) for x in b.run_iter(
            (ds.next_batch() for _ in range(10)), fetches="loss",
            skip="auto")]
        ds.close()
        assert lb == la[5:]
        assert b.state.step == 10
        b.close()


# -- the manifest against the JAX package's -----------------------------------


def _tiny_resnet(monkeypatch):
    kw = dict(stage_sizes=[1, 1, 1, 1], num_filters=8)
    monkeypatch.setitem(jcnn.MODEL_REGISTRY, "tiny_resnet", (
        lambda **k: jresnet.ResNet(**kw, dtype=jnp.float32, **k), 32))
    monkeypatch.setitem(tcnn.MODEL_REGISTRY, "tiny_resnet", (
        lambda **k: tresnet.ResNet(**kw, dtype=torch.float32, **k), 32))


def _manifest_case(name, monkeypatch):
    """(JAX model, port model, batch, Config kwargs, parallel_run kwargs)."""
    rng = np.random.default_rng(0)
    if name.startswith("lm1b"):
        mode = "slices" if name == "lm1b_slices" else "dense"
        b = jlm1b.make_batch(rng, 8, 5, 1000)
        return (jlm1b.build_model(jlm1b.tiny_config(sparse_grad_mode=mode)),
                tlm1b.build_model(tlm1b.tiny_config(sparse_grad_mode=mode)),
                b, dict(run_option="HYBRID", sparse_grad_mode=mode),
                dict(sync=name != "lm1b_async"))
    if name == "nmt":
        cfg = jnmt.tiny_config()
        return (jnmt.build_model(cfg), tnmt.build_model(tnmt.tiny_config()),
                jnmt.make_batch(rng, 4, 12, 10, cfg.vocab_size), {}, {})
    if name == "bert":
        cfg = jbert.tiny_config(num_partitions=1)
        return (jbert.build_model(cfg),
                tbert.build_model(tbert.tiny_config(num_partitions=1)),
                jbert.make_batch(rng, 4, 16, 3, cfg.vocab_size), {}, {})
    if name == "resnet":
        _tiny_resnet(monkeypatch)
        return (jcnn.build_model("tiny_resnet", num_classes=10,
                                 image_size=32),
                tcnn.build_model("tiny_resnet", num_classes=10,
                                 image_size=32),
                jcnn.make_batch(rng, 4, 32, 10), dict(run_option="AR"), {})
    if name == "long_context":
        cfg = jlc.tiny_config()
        return (jlc.build_model(cfg), tlc.build_model(tlc.tiny_config()),
                jlc.make_batch(rng, 2, 16, cfg.vocab_size), {}, {})
    if name.startswith("lc_pipeline"):
        kw = dict(parallelism="pipeline", num_layers=4,
                  pipeline_schedule="gpipe")
        if name == "lc_pipeline_v2":
            kw.update(virtual_stages=2, pipeline_stages=2,
                      pipeline_schedule="1f1b")
        cfg = jlc.tiny_config(**kw)
        return (jlc.build_model(cfg), tlc.build_model(tlc.tiny_config(**kw)),
                jlc.make_batch(rng, 2, 16, cfg.vocab_size), {}, {})
    if name == "skip_thoughts":
        cfg = jst.tiny_config(num_partitions=1)
        return (jst.build_model(cfg),
                tst.build_model(tst.tiny_config(num_partitions=1)),
                jst.make_batch(rng, 4, 6, cfg.vocab_size), {}, {})
    if name == "lm1b_full":
        return (jlm1b.build_full_softmax_model(jlm1b.tiny_config()),
                tlm1b.build_full_softmax_model(tlm1b.tiny_config()),
                jlm1b.make_batch(rng, 8, 5, 1000),
                dict(run_option="HYBRID"), {})
    cfg = jmoe.tiny_config()
    return (jmoe.build_model(cfg), tmoe.build_model(tmoe.tiny_config()),
            jmoe.make_batch(rng, 2, 16, cfg.vocab_size), {}, {})


@pytest.mark.parametrize("name", ["lm1b_slices", "lm1b_dense", "lm1b_async",
                                  "nmt", "bert", "resnet", "long_context",
                                  "moe_lm", "skip_thoughts", "lm1b_full",
                                  "lc_pipeline_v1", "lc_pipeline_v2"])
def test_manifest_names_shapes_dtypes_equal_jax(name, monkeypatch, tmp_path):
    jmodel, tmodel, batch, cfg_kw, run_kw = _manifest_case(name, monkeypatch)
    # a JAX pipeline engine switches the process's persistent compilation
    # cache off for good (parallax_tpu/core/engine.py:302-340, an XLA:CPU
    # workaround); the cache stays off only while this session lives
    from parallax_tpu.core import engine as jengine_lib
    monkeypatch.setattr(jengine_lib, "_pipeline_cache_guarded", False)
    cache_dir = jax.config.jax_compilation_cache_dir
    jsess, *_ = jparallax.parallel_run(
        jmodel, parallax_config=jparallax.Config(search_partitions=False,
                                                 **cfg_kw),
        num_partitions=1, seed=0, **run_kw)
    try:
        jsess.prepare(batch)
        want = {n: (tuple(np.shape(v)), str(v.dtype))
                for n, v in jsnap.flatten_with_names(jsess.state)[0]}
    finally:
        jsess.close()
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    ck = str(tmp_path / "ck")
    tsess, *_ = tparallax.parallel_run(
        tmodel, parallax_config=tparallax.Config(
            ckpt_config=tparallax.CheckPointConfig(ckpt_dir=ck),
            **cfg_kw), seed=0, device="cpu", **run_kw)
    tsess.prepare(batch)
    tsess._ckpt.save_now(0, tsess._state_leaves())
    tsess.close()
    got = {n: (tuple(e["shape"]), e["dtype"]) for n, e in
           CheckpointStore(ck).read_manifest(0)["leaves"].items()}
    assert got == want
    if name == "lm1b_async":
        assert any(n.startswith("pending_grads/") for n in got)
    if name == "resnet":
        assert any(n.startswith("model_state/batch_stats/") for n in got)
    if name.startswith("lc_pipeline"):
        assert got["params/blocks_stacked/wqkv"] == ((4, 32, 96), "float32")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_rng_leaf_is_jax_prng_key_of_seed_plus_one(seed):
    key = tsnap.rng_leaf(seed)
    np.testing.assert_array_equal(
        key, np.asarray(jax.random.PRNGKey(seed + 1)))
    assert key.dtype == np.uint32
    # the key keeps the low 32 bits (JAX's without x64): the run's own
    # seed is kept where they agree
    assert tsnap.seed_of_rng(key, seed) == seed
    if seed < 2 ** 32 - 1:
        assert tsnap.seed_of_rng(key) == seed


# -- across packages ----------------------------------------------------------


SEED = 0
LM1B = dict(num_partitions=8, keep_prob=1.0, sparse_grad_mode="slices")


def _lm1b_batches(vocab, n=6):
    rng = np.random.default_rng(0)
    return [jlm1b.make_batch(rng, 16, 6, vocab) for _ in range(n)]


def _jax_candidates(cfg, steps):
    base = jax.random.PRNGKey(SEED + 1)
    out = []
    for step in steps:
        _drop, samp = jax.random.split(jax.random.fold_in(base, step))
        out.append(np.asarray(jss.log_uniform_candidates(
            samp, cfg.num_samples, cfg.vocab_size)))
    return out


def _feed_candidates(monkeypatch, ids_list):
    it = iter(ids_list)

    def fake(gen, num_samples, vocab_size, device=None):
        if torch.device(device).type == "meta":
            return torch.zeros((num_samples,), dtype=torch.long,
                               device="meta")
        return torch.tensor(next(it), dtype=torch.long, device=device)

    monkeypatch.setattr(tss, "log_uniform_candidates", fake)


def _jax_lm1b(ck, every):
    cfg = jlm1b.tiny_config(**LM1B, compute_dtype=jnp.float32)
    sess, *_ = jparallax.parallel_run(
        jlm1b.build_model(cfg), parallax_config=jparallax.Config(
            run_option="HYBRID", sparse_grad_mode="slices",
            search_partitions=False,
            ckpt_config=jparallax.CheckPointConfig(
                ckpt_dir=ck, save_ckpt_steps=every)), seed=SEED)
    return cfg, sess


def _port_lm1b(ck, every):
    cfg = tlm1b.tiny_config(**LM1B, compute_dtype=torch.float32,
                            lstm_impl="kernel")
    sess, *_ = tparallax.parallel_run(
        tlm1b.build_model(cfg), parallax_config=tparallax.Config(
            run_option="HYBRID", sparse_grad_mode="slices",
            ckpt_config=tparallax.CheckPointConfig(
                ckpt_dir=ck, save_ckpt_steps=every)), seed=SEED,
        device="cpu")
    return cfg, sess


def test_jax_checkpoint_resumes_in_port(tmp_path, monkeypatch):
    ck = str(tmp_path / "jax")
    jcfg, jsess = _jax_lm1b(ck, every=3)
    batches = _lm1b_batches(jcfg.vocab_size)
    try:
        jsess.prepare(batches[0])
        jlosses = [float(jsess.run("loss", feed_dict=b)) for b in batches]
    finally:
        jsess.close()
    shutil.rmtree(os.path.join(ck, "6"))
    _feed_candidates(monkeypatch, _jax_candidates(jcfg, range(3, 6)))
    _, tsess = _port_lm1b(ck, every=100)
    assert tsess.prepare(batches[0]) == 3
    assert tsess.data_cursor == 3 and tsess.state.seed == SEED
    tlosses = [float(tsess.run("loss", feed_dict=b)) for b in batches[3:]]
    np.testing.assert_allclose(tlosses, jlosses[3:], rtol=1e-4)
    tsess.close()


def test_port_checkpoint_resumes_in_jax(tmp_path, monkeypatch):
    ck = str(tmp_path / "port")
    jcfg = jlm1b.tiny_config(**LM1B, compute_dtype=jnp.float32)
    batches = _lm1b_batches(jcfg.vocab_size)
    _feed_candidates(monkeypatch, _jax_candidates(jcfg, range(6)))
    _, tsess = _port_lm1b(ck, every=3)
    tlosses = [float(tsess.run("loss", feed_dict=b)) for b in batches]
    tsess.close()
    shutil.rmtree(os.path.join(ck, "6"))
    _, jsess = _jax_lm1b(ck, every=100)
    try:
        assert jsess.prepare(batches[0]) == 3
        assert jsess.data_cursor == 3
        jlosses = [float(jsess.run("loss", feed_dict=b))
                   for b in batches[3:]]
    finally:
        jsess.close()
    np.testing.assert_allclose(jlosses, tlosses[3:], rtol=1e-4)


def test_whole_state_carries_across_by_name(monkeypatch):
    """``weights.state_from_jax_checkpoint`` loads a JAX session's state
    into a port session in place, and ``state_to_jax_names`` gives it
    back equal to the JAX arrays."""
    jcfg, jsess = _jax_lm1b(None, every=100)
    batches = _lm1b_batches(jcfg.vocab_size, 2)
    try:
        jsess.prepare(batches[0])
        jsess.run("loss", feed_dict=batches[0])
        named = {n: np.asarray(v)
                 for n, v in jsnap.flatten_with_names(jsess.state)[0]}
    finally:
        jsess.close()
    _, tsess = _port_lm1b(None, every=100)
    tsess.prepare(batches[0])
    ids = [id(leaf.value) for leaf in tsess._state_leaves()
           if isinstance(leaf.value, torch.Tensor)]
    weights.state_from_jax_checkpoint(named, tsess.state, tsess.engine)
    assert tsess.state.step == 1
    assert ids == [id(leaf.value) for leaf in tsess._state_leaves()
                   if isinstance(leaf.value, torch.Tensor)]
    back = weights.state_to_jax_names(tsess.state, tsess.engine)
    assert set(back) == set(named)
    for n, v in named.items():
        np.testing.assert_array_equal(back[n].numpy(), v, err_msg=n)
    with pytest.raises(ValueError, match="missing"):
        weights.state_from_jax_checkpoint(
            {k: v for k, v in named.items() if k != "rng"}, tsess.state,
            tsess.engine)
    tsess.close()


def test_resnet_conv_kernels_are_written_in_flax_layout(tmp_path,
                                                        monkeypatch):
    """A small ResNet's checkpoint restores in the JAX session and the
    JAX arrays equal the port's parameters in flax's layout."""
    _tiny_resnet(monkeypatch)
    batch = jcnn.make_batch(np.random.default_rng(0), 4, 32, 10)
    ck = str(tmp_path / "ck")
    tsess, *_ = tparallax.parallel_run(
        tcnn.build_model("tiny_resnet", num_classes=10, image_size=32),
        parallax_config=tparallax.Config(
            run_option="AR", ckpt_config=tparallax.CheckPointConfig(
                ckpt_dir=ck, save_ckpt_steps=1)), device="cpu")
    tsess.run("loss", feed_dict=batch)
    back = weights.state_to_jax_names(tsess.state, tsess.engine)
    tsess.close()
    jsess, *_ = jparallax.parallel_run(
        jcnn.build_model("tiny_resnet", num_classes=10, image_size=32),
        parallax_config=jparallax.Config(
            run_option="AR", search_partitions=False,
            ckpt_config=jparallax.CheckPointConfig(ckpt_dir=ck,
                                                   save_ckpt_steps=100)),
        num_partitions=1)
    try:
        assert jsess.prepare(batch) == 1
        named = dict(jsnap.flatten_with_names(jsess.state)[0])
    finally:
        jsess.close()
    conv = [n for n, v in back.items() if v.ndim == 4]
    assert conv and all(n.startswith(("params/", "opt_state/"))
                        for n in conv)
    for n, v in back.items():
        np.testing.assert_array_equal(np.asarray(named[n]), v.numpy(),
                                      err_msg=n)


# -- resharded restore --------------------------------------------------------


def _toy_inputs():
    rng = np.random.default_rng(11)
    init = {"emb": rng.standard_normal((32, 8)).astype(np.float32),
            "proj": {"w": rng.standard_normal((8, 4)).astype(np.float32)}}
    batches = []
    for i in range(8):
        r = np.random.default_rng(500 + i)
        batches.append({"ids": r.permutation(32)[:8].astype(np.int32),
                        "y": r.standard_normal((8, 4)).astype(np.float32)})
    return init, batches


def test_resharded_restore_between_two_ranks_and_one(tmp_path):
    """Saved on two gloo ranks (emb row-sharded over (1, 2)), continued on
    two ranks and on one; saved on one rank, continued on one and on
    two: the continuations' losses and parameters agree (rtol 1e-5)."""
    init, batches = _toy_inputs()
    two, one = str(tmp_path / "two"), str(tmp_path / "one")
    saved_one = bodies.ckpt_toy(0, 1, [(one, 2, 4)], init, batches)[0]
    assert saved_one["placements"]["emb"] == "replicated"
    ranks = run_ranks(tmp_path, 2, "ckpt_toy",
                      jobs=[(two, 2, 4), (two, 10 ** 6, 8),
                            (one, 10 ** 6, 8)], init=init, batches=batches)
    saved_two, two_on_two, one_on_two = ranks[0]
    assert saved_two["placements"]["emb"] == "row_sharded"
    assert {len(r) for r in ranks} == {3}
    m = CheckpointStore(two).read_manifest(4)
    assert m["process_count"] == 2
    assert len(m["leaves"]["params/emb"]["shards"]) == 2
    assert len(m["leaves"]["params/proj/w"]["shards"]) == 1
    np.testing.assert_allclose(saved_two["losses"], saved_one["losses"],
                               rtol=1e-5)
    two_on_one, one_on_one = bodies.ckpt_toy(
        0, 1, [(two, 10 ** 6, 8), (one, 10 ** 6, 8)], init, batches)
    for a, b in ((two_on_two, two_on_one), (one_on_one, one_on_two)):
        assert a["step"] == b["step"] == 4
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
        for p in a["params"]:
            np.testing.assert_allclose(a["params"][p], b["params"][p],
                                       rtol=1e-5, atol=1e-6)


def test_tensor_parallel_checkpoint_restores_on_one_rank(tmp_path):
    """BERT tiny tensor-parallel over two gloo ranks (1, 2) saves at step
    2: its manifest holds the fused ``wqkv``'s column blocks and the
    row-parallel weights as global extents, and one rank restores it and
    continues as the two ranks do (losses rtol 1e-4, parameters 1e-5)."""
    from parallax_tpu.models import bert as jbert_
    rng = np.random.default_rng(5)
    batches = [jbert_.make_batch(rng, 8, 16, 3, 500) for _ in range(4)]
    ck = str(tmp_path / "tp")
    saved, cont = run_ranks(tmp_path, 2, "ckpt_bert_tp",
                            jobs=[(ck, 2, 2), (ck, 10 ** 6, 4)],
                            batches=batches)[0]
    assert saved["placements"]["blocks/0/wqkv"] == "tp_column"
    assert "tp_row" in saved["placements"].values()
    m = CheckpointStore(ck).read_manifest(2)
    assert m["process_count"] == 2
    assert len(m["leaves"]["params/blocks/0/wqkv"]["shards"]) == 6
    one = bodies.ckpt_bert_tp(0, 1, [(ck, 10 ** 6, 4)], batches)[0]
    assert cont["step"] == one["step"] == 2
    np.testing.assert_allclose(one["losses"], cont["losses"], rtol=1e-4)
    for p, v in cont["params"].items():
        np.testing.assert_allclose(one["params"][p], v, rtol=1e-5,
                                   atol=1e-6, err_msg=p)


@pytest.mark.parametrize("virtual", [1, 2])
def test_pipeline_checkpoint_restores_on_one_rank(tmp_path, virtual):
    """The long-context LM in pipeline mode (4 layers, 2 microbatches;
    GPipe at V 1, 1F1B at V 2 with device-major storage) over two gloo
    ranks (1, 2) saves at step 2: each rank writes its stage rows as its
    extent of the global ``[4, ...]`` stack. One rank restores it to the
    two ranks' gathered parameters exactly and continues as they do
    (losses rtol 1e-4, parameters 1e-5)."""
    rng = np.random.default_rng(6)
    batches = [jlc.make_batch(rng, 8, 16, 512) for _ in range(4)]
    kw = dict(num_layers=4, max_len=16, num_microbatches=2,
              pipeline_schedule="gpipe")
    if virtual == 2:
        kw.update(virtual_stages=2, pipeline_stages=2,
                  pipeline_schedule="1f1b")
    ck = str(tmp_path / "pp")
    saved, cont = run_ranks(tmp_path, 2, "ckpt_pipe",
                            jobs=[(ck, 2, 2), (ck, 10 ** 6, 4)], cfg_kw=kw,
                            batches=batches)[0]
    assert saved["placements"]["blocks_stacked/wqkv"] == "stage_sharded"
    m = CheckpointStore(ck).read_manifest(2)
    assert m["process_count"] == 2
    leaf = m["leaves"]["params/blocks_stacked/wqkv"]
    assert tuple(leaf["shape"]) == (4, 32, 96)
    assert len(leaf["shards"]) == 2
    assert len(m["leaves"]["params/emb"]["shards"]) == 1
    restored, one = bodies.ckpt_pipe(0, 1, [(ck, 10 ** 6, 2),
                                            (ck, 10 ** 6, 4)], kw, batches)
    assert restored["placements"]["blocks_stacked/wqkv"] == "replicated"
    assert cont["step"] == restored["step"] == one["step"] == 2
    for p, v in saved["params"].items():
        np.testing.assert_array_equal(restored["params"][p], v, err_msg=p)
    np.testing.assert_allclose(one["losses"], cont["losses"], rtol=1e-4)
    for p, v in cont["params"].items():
        np.testing.assert_allclose(one["params"][p], v, rtol=1e-5,
                                   atol=1e-6, err_msg=p)


def test_restore_train_state_eval_flow(tmp_path):
    """``restore_train_state`` lands the checkpoint whole (no example
    batch) and onto a live plan."""
    init, batches = _toy_inputs()
    ck = str(tmp_path / "ck")
    saved = bodies.ckpt_toy(0, 1, [(ck, 2, 2)], init, batches)[0]
    state, step = restore_train_state(ck, bodies.toy_model(), device="cpu")
    assert step == 2 and state.step == 2
    np.testing.assert_array_equal(state.params["emb"].numpy(),
                                  saved["params"]["emb"])
    state2, step2 = restore_train_state(
        ck, bodies.toy_model(), example_batch=batches[0], device="cpu",
        config=tparallax.Config(run_option="HYBRID"))
    assert step2 == 2
    np.testing.assert_array_equal(state2.params["proj"]["w"].detach().numpy(),
                                  saved["params"]["proj/w"])
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "none"), bodies.toy_model(),
                            device="cpu")


def test_restore_train_state_rebuilds_pending_grads(tmp_path):
    ck = str(tmp_path / "ck")
    sess, *_ = tparallax.parallel_run(
        tsimple.build_model(0.1), parallax_config=_cfg(ck, every=2),
        sync=False, device="cpu")
    for i in range(2):
        sess.run("loss", feed_dict=batch_for(i))
    pending = {k: v.clone() for k, v in sess.state.pending_grads.items()}
    sess.close()
    state, step = restore_train_state(ck, tsimple.build_model(0.1),
                                      device="cpu")
    assert step == 2 and set(state.pending_grads) == set(pending)
    for k, v in pending.items():
        assert torch.equal(state.pending_grads[k], v)


# -- NaN recovery -------------------------------------------------------------


class TestRecovery:
    def _cfg(self, max_retries=2):
        return tparallax.Config(
            run_option="AR", recovery_config=tparallax.RecoveryConfig(
                enabled=True, snapshot_every_steps=2,
                max_retries=max_retries))

    def test_rollback_skips_batch_and_continues(self):
        sess = _session(self._cfg())
        calls = []
        sess.set_rollback_hook(calls.append)
        losses = [float(sess.run("loss", feed_dict=batch_for(i, i == 5)))
                  for i in range(10)]
        assert sess._recovery.total_rollbacks == 1
        assert calls == [1]
        assert np.isfinite(losses[-1]) and not np.isfinite(losses[5])
        # the cursor counted every batch; the step rewound to the
        # snapshot (step 4) and re-advanced over batches 6..9
        assert sess.data_cursor == 10
        assert sess.state.step == 8
        sess.close()

    def test_losses_after_rollback_equal_a_run_without_the_batch(self):
        """Snapshot at step 4, the NaN batch at step 4: after the
        rollback the run is, bit for bit, one that never saw it."""
        sess = _session(self._cfg())
        got = [float(sess.run("loss", feed_dict=batch_for(i, i == 4)))
               for i in range(9)]
        sess.close()
        sess = _session(tparallax.Config(run_option="AR"))
        want = [float(sess.run("loss", feed_dict=batch_for(i)))
                for i in range(9) if i != 4]
        sess.close()
        assert got[:4] + got[5:] == want

    def test_health_outputs(self):
        sess = _session(tparallax.Config(run_option="AR",
                                         monitor_health=True))
        out = sess.run(None, feed_dict=batch_for(0))
        assert bool(out["loss_finite"]) and np.isfinite(
            float(out["grad_norm"])) and float(out["grad_norm"]) > 0
        out = sess.run(None, feed_dict=batch_for(1, nan=True))
        assert not bool(out["loss_finite"])
        sess.close()

    def test_health_grad_norm_matches_jax(self):
        """grad_norm against the JAX engine's in-graph output, one step
        of LM1B tiny (slices: the dense group and the row slices)."""
        jcfg, jsess = _jax_lm1b(None, every=100)
        jsess._config.monitor_health = True
        batches = _lm1b_batches(jcfg.vocab_size, 1)
        try:
            jsess.prepare(batches[0])
            init = jax.tree.map(np.asarray, jsess.state.params)
            jnorm = float(jsess.run("grad_norm", feed_dict=batches[0]))
        finally:
            jsess.close()
        tcfg = tlm1b.tiny_config(**LM1B, compute_dtype=torch.float32,
                                 lstm_impl="kernel")
        tsess, *_ = tparallax.parallel_run(
            tlm1b.build_model(tcfg), parallax_config=tparallax.Config(
                run_option="HYBRID", sparse_grad_mode="slices",
                monitor_health=True), seed=SEED, device="cpu")
        tsess.prepare(batches[0])
        carried = dict(weights.flatten(weights.lm1b_params_from_jax(
            init, tcfg, "cpu")))
        with torch.no_grad():
            for path, leaf in weights.flatten(tsess.state.params):
                leaf.copy_(carried[path])
        ids = _jax_candidates(jcfg, [0])
        mp = pytest.MonkeyPatch()
        _feed_candidates(mp, ids)
        try:
            tnorm = float(tsess.run("grad_norm", feed_dict=batches[0]))
        finally:
            mp.undo()
        tsess.close()
        assert tnorm == pytest.approx(jnorm, rel=1e-4)

    def test_reserved_health_names_refused(self):
        def loss_fn(params, batch):
            loss = (params["w"] * batch["x"]).sum()
            return loss, {"grad_norm": loss}

        model = tparallax.Model(
            lambda gen, device: {"w": torch.ones(2, device=device)},
            loss_fn)
        sess, *_ = tparallax.parallel_run(
            model, parallax_config=tparallax.Config(monitor_health=True),
            device="cpu")
        with pytest.raises(ValueError, match="reserves"):
            sess.run("loss", feed_dict={"x": np.ones((4, 2), np.float32)})

    def test_surrender_after_bounded_retries(self):
        sess = _session(self._cfg(max_retries=2))
        with pytest.raises(RecoverySurrender):
            for i in range(10):
                sess.run("loss", feed_dict=batch_for(i, nan=True))
        assert sess._recovery.total_rollbacks == 2
        sess.close()


# -- preemption ---------------------------------------------------------------


class TestPreemption:
    def test_on_preemption_saves(self, tmp_path):
        ck = str(tmp_path / "ck")
        sess = _session(_cfg(ck, every=100))
        for i in range(3):
            sess.run("loss", feed_dict=batch_for(i))
        sess.on_preemption(signal.SIGTERM)
        assert CheckpointStore(ck).complete_steps() == [3]
        sess.close()
        # a closed session's handler passes the signal on, saving nothing
        sess.on_preemption(signal.SIGTERM)
        assert CheckpointStore(ck).complete_steps() == [3]

    def test_handler_not_installed_without_ckpt_dir(self):
        sess = _session(tparallax.Config(run_option="AR"))
        assert not sess._sigterm_installed
        sess.close()


def _subprocess(script, *args, env=None, timeout=30):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(script), *args],
        cwd=str(ROOT), capture_output=True, text=True, timeout=timeout,
        env={**os.environ, **(env or {})})


TRAIN_SCRIPT = """
    import os, signal, sys, time
    import numpy as np
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import simple
    ck, every, steps, kill = sys.argv[1], int(sys.argv[2]), \\
        int(sys.argv[3]), sys.argv[4] == "kill"
    cfg = pt.Config(run_option="AR", ckpt_config=pt.CheckPointConfig(
        ckpt_dir=ck, save_ckpt_steps=every))
    sess, *_ = pt.parallel_run(simple.build_model(0.1), parallax_config=cfg,
                               device="cpu")
    start = sess.prepare(simple.make_batch(np.random.default_rng(0), 32))
    print("START", start, "HANDLER", sess._sigterm_installed, flush=True)
    for i in range(start, steps):
        sess.run("loss",
                 feed_dict=simple.make_batch(np.random.default_rng(i), 32))
    if kill:
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(20)
        print("SURVIVED", flush=True)
    sess.close()
"""


def test_sigterm_saves_then_terminates(tmp_path):
    ck = str(tmp_path / "ck")
    proc = _subprocess(TRAIN_SCRIPT, ck, "100", "3", "kill")
    assert "START 0 HANDLER True" in proc.stdout, proc.stderr[-2000:]
    assert proc.returncode == -signal.SIGTERM, proc.stderr[-2000:]
    assert "SURVIVED" not in proc.stdout
    assert CheckpointStore(ck).complete_steps() == [3]
    extras = CheckpointStore(ck).restore_extras(3)
    assert extras["data_cursor"] == 3


def test_torn_manifest_fault_falls_back(tmp_path):
    ck = str(tmp_path / "ck")
    proc = _subprocess(TRAIN_SCRIPT, ck, "2", "2", "run")
    assert proc.returncode == 0, proc.stderr[-2000:]
    proc = _subprocess(TRAIN_SCRIPT, ck, "2", "4", "run",
                       env={"PARALLAX_CKPT_FAULT": "torn_manifest"})
    assert "START 2" in proc.stdout
    assert proc.returncode == 31, proc.stderr[-2000:]
    store = CheckpointStore(ck)
    assert store.complete_steps() == [2] and store.all_steps() == [2, 4]
    proc = _subprocess(TRAIN_SCRIPT, ck, "2", "4", "run")
    assert proc.returncode == 0 and "START 2" in proc.stdout
    assert CheckpointStore(ck).complete_steps() == [2, 4]
