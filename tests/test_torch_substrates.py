"""The port's training substrates: data pipeline, optimizer, compression,
checkpointing and the supervisor.

Twins of tests/test_substrates.py's TestData, TestAdamW,
TestCompression, TestCheckpoint and TestSupervisor, plus the port held
against the JAX package on shared inputs:

- `SyntheticLM` batches equal JAX's element for element;
- `schedule` is JAX's float32 arithmetic: within 2 ulp of JAX's eager
  schedule (the cosines differ by 2 ulp at 1 of 83 steps), within 4 of
  its jitted one (JAX's own eager and jitted schedules differ by 4);
- `compress` and `ef_roundtrip` equal JAX's bit for bit (payload,
  scales, survivors and error buffers);
- twelve `adamw.update` steps on a shared numpy tree (clipping active on
  every other step) keep parameters, m and v within 1e-6 of each leaf's
  largest element of JAX's (the norms are sums in another order: the
  worst seen is 3.2e-7), the first step within 1 ulp;
- a checkpoint of the port's train state restores into JAX's
  `CheckpointManager` with JAX's structure, and the reverse: both write
  numpy leaves in `jax.tree_util`'s order.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as jadamw
from repro.optim.compression import compress as jcompress
from repro.optim.compression import ef_roundtrip as jef_roundtrip
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import init_train_state as jinit_train_state
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, to_device
from repro_torch.optim import adamw
from repro_torch.optim.compression import (
    compress,
    decompress,
    ef_roundtrip,
    init_error_buf,
)
from repro_torch.runtime.supervisor import (
    FailureInjector,
    SimulatedFailure,
    StragglerDetector,
    Supervisor,
)
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step
from repro_torch.tree_util import flatten, leaves, tree_map
from test_torch_train_model import one_thread  # noqa: F401  (autouse fixture)

GEN = lambda seed=0: torch.Generator().manual_seed(seed)  # noqa: E731


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _ulps(a, b):
    return int(np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64)).max())


class TestData:
    def test_deterministic_and_seekable(self):
        d = SyntheticLM(100, 16, 8, seed=3)
        b1 = d.batch_at(5)
        b2 = d.batch_at(5)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        assert not np.array_equal(d.batch_at(6)["tokens"], b1["tokens"])

    def test_labels_are_shifted_tokens(self):
        d = SyntheticLM(100, 16, 4)
        b = d.batch_at(0)
        assert b["tokens"].shape == b["labels"].shape == (4, 16)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_sharding_partitions_global_batch(self):
        full = SyntheticLM(100, 8, 8, seed=1).batch_at(2)
        p0 = SyntheticLM(100, 8, 8, seed=1, process_index=0, process_count=2)
        p1 = SyntheticLM(100, 8, 8, seed=1, process_index=1, process_count=2)
        np.testing.assert_array_equal(
            np.concatenate([p0.batch_at(2)["tokens"], p1.batch_at(2)["tokens"]]),
            full["tokens"],
        )
        with pytest.raises(ValueError):
            SyntheticLM(100, 8, 7, process_count=2)

    def test_prefetcher(self):
        d = SyntheticLM(100, 8, 4)
        it = Prefetcher(iter(d), depth=2, place=lambda b: to_device(b, "cpu"))
        a = next(it)
        b = next(it)
        assert isinstance(a["tokens"], torch.Tensor) and a["tokens"].dtype == torch.int32
        assert not torch.equal(a["tokens"], b["tokens"])

    @pytest.mark.parametrize("vocab, seq, batch, seed, structured", [
        (256, 32, 8, 0, True), (50304, 64, 4, 7, True), (100, 16, 6, 3, False)])
    def test_batches_equal_jax(self, vocab, seq, batch, seed, structured):
        for pc in (1, 2):
            for pi in range(pc):
                kw = dict(seed=seed, process_index=pi, process_count=pc,
                          structured=structured)
                mine = SyntheticLM(vocab, seq, batch, **kw)
                theirs = JSyntheticLM(vocab, seq, batch, **kw)
                for step in (0, 1, 17, 123456):
                    a, b = mine.batch_at(step), theirs.batch_at(step)
                    for k in ("tokens", "labels"):
                        assert a[k].dtype == b[k].dtype == np.int32
                        np.testing.assert_array_equal(a[k], b[k])


class TestAdamW:
    def test_descends_quadratic(self):
        cfg = adamw.AdamWConfig(peak_lr=0.1, warmup_steps=1, total_steps=100)
        params = {"w": torch.tensor([2.0, -3.0])}
        state = adamw.init(params)
        for _ in range(100):
            grads = {"w": 2 * params["w"]}
            params, state, m = adamw.update(cfg, grads, state, params)
        assert float(params["w"].abs().max()) < 0.2
        assert state.step.dtype == torch.int32 and int(state.step) == 100

    def test_clipping(self):
        cfg = adamw.AdamWConfig(clip_norm=1.0, warmup_steps=1)
        params = {"w": torch.zeros(4)}
        state = adamw.init(params)
        _, _, m = adamw.update(cfg, {"w": torch.full((4,), 100.0)}, state, params)
        assert float(m["grad_norm"]) == pytest.approx(200.0)

    def test_schedule_shape(self):
        cfg = adamw.AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                                min_lr_ratio=0.1)
        assert float(adamw.schedule(cfg, 0)) == 0.0
        assert float(adamw.schedule(cfg, 10)) == pytest.approx(1.0)
        assert float(adamw.schedule(cfg, 100)) == pytest.approx(0.1)

    def test_schedule_equals_jax(self):
        for kw in (dict(peak_lr=3e-4, warmup_steps=2, total_steps=6),
                   dict(peak_lr=3e-3, warmup_steps=20, total_steps=40),
                   dict(peak_lr=1.0, warmup_steps=0, total_steps=1, min_lr_ratio=0.3)):
            cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
            steps = np.arange(0, 2 * kw["total_steps"] + 3, dtype=np.int32)
            mine = adamw.schedule(cfg, torch.from_numpy(steps))
            theirs = jadamw.schedule(jcfg, jnp.asarray(steps))
            assert mine.dtype == torch.float32
            assert _ulps(mine.numpy(), theirs) <= 2

    def test_update_tracks_jax(self):
        rng = np.random.default_rng(0)
        shapes = {"w": (3, 50), "b": (50,), "s": (4, 3, 40)}
        p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=10, clip_norm=1.0)
        cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        js = jadamw.init(jp)
        tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        ts = adamw.init(tp)
        jupdate = jax.jit(lambda g, s, p: jadamw.update(jcfg, g, s, p))
        for i in range(12):
            # every other step's norm exceeds the clip
            g = {k: (rng.standard_normal(s) * (3 if i % 2 else 0.01)).astype(np.float32)
                 for k, s in shapes.items()}
            jp, js, jm = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
            tp, ts, tm = adamw.update(cfg, {k: torch.from_numpy(v.copy())
                                            for k, v in g.items()}, ts, tp)
            assert int(ts.step) == int(js.step) == i + 1
            assert _ulps(tm["lr"].numpy(), jm["lr"]) <= 4
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=1e-6)
            if i == 0:
                for k in shapes:
                    assert _ulps(tp[k].numpy(), jp[k]) <= 1, k
        for k in shapes:
            for mine, theirs in ((tp[k], jp[k]), (ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
                theirs = np.asarray(theirs)
                err = np.abs(mine.numpy() - theirs).max() / np.abs(theirs).max()
                assert err <= 1e-6, k

    def test_update_is_in_place(self):
        params = {"a": torch.ones(2, 3), "b": torch.ones(3)}
        state = adamw.init(params)
        ptrs = [t.data_ptr() for t in leaves((params, state.m, state.v))]
        new, st, _ = adamw.update(adamw.AdamWConfig(warmup_steps=1),
                                  tree_map(torch.ones_like, params), state, params)
        assert [t.data_ptr() for t in leaves((new, st.m, st.v))] == ptrs
        # decay by JAX's rule: ndim >= 2 only
        g0 = tree_map(torch.zeros_like, params)
        before = {k: v.clone() for k, v in new.items()}
        new, st, _ = adamw.update(adamw.AdamWConfig(warmup_steps=1, b1=0.0, b2=0.0),
                                  g0, st, new)
        assert (new["a"] < before["a"]).all() and torch.equal(new["b"], before["b"])


class TestCompression:
    def test_roundtrip_error_bounded(self):
        g = torch.randn(1000, generator=GEN())
        q, s = compress(g)
        rec = decompress(q, s, g.shape)
        assert float((rec - g).abs().max()) <= float(s.max()) + 1e-6

    def test_error_feedback_accumulates(self):
        g = {"w": torch.randn(300, generator=GEN()) * 1e-3}
        ebuf = init_error_buf(g)
        rec, ebuf = ef_roundtrip(g, ebuf)
        # the residual is carried, not lost
        np.testing.assert_allclose((rec["w"] + ebuf["w"]).numpy(), g["w"].numpy(),
                                   atol=1e-6)

    def test_wire_volume(self):
        q, s = compress(torch.ones(4096))
        assert q.dtype == torch.int8
        assert q.numel() == 4096 and s.numel() == 16  # 1B/elem + 1/256 scales

    def test_codec_equals_jax_bit_for_bit(self):
        rng = np.random.default_rng(1)
        tree = {"a": rng.standard_normal((7, 300)).astype(np.float32) * 1e-3,
                "b": rng.standard_normal(5).astype(np.float32),
                "c": np.zeros((2, 256), np.float32)}
        for g in tree.values():
            q, s = compress(torch.from_numpy(g))
            jq, js = jcompress(jnp.asarray(g))
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
        ebuf = init_error_buf({k: torch.from_numpy(v) for k, v in tree.items()})
        jebuf = jax.tree.map(jnp.zeros_like, tree)
        for _ in range(4):
            rec, ebuf = ef_roundtrip({k: torch.from_numpy(v) for k, v in tree.items()},
                                     ebuf)
            jrec, jebuf = jef_roundtrip(tree, jebuf)
            for k in tree:
                np.testing.assert_array_equal(_bits(rec[k].numpy()), _bits(jrec[k]))
                np.testing.assert_array_equal(_bits(ebuf[k].numpy()), _bits(jebuf[k]))


class TestCheckpoint:
    def test_save_restore_roundtrip(self):
        tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4))}}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, async_io=False)
            mgr.save(7, tree)
            assert mgr.latest_step() == 7
            out = mgr.restore(7, like=tree)
            assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"],
                                                                    tree["b"]["c"])

    def test_retention_gc(self):
        tree = {"a": torch.zeros(2)}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, keep=2, async_io=False)
            for s in (1, 2, 3, 4):
                mgr.save(s, tree)
            assert mgr.all_steps() == [3, 4]

    def test_corruption_detected(self):
        tree = {"a": torch.arange(5.0)}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, async_io=False)
            mgr.save(1, tree)
            path = os.path.join(d, "step_00000001", "leaf_00000.npy")
            with open(path, "r+b") as f:
                f.seek(-1, 2)
                f.write(b"\x00")
            with pytest.raises(IOError):
                mgr.restore(1, like=tree)

    def test_async_save(self):
        tree = {"a": torch.arange(100.0)}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, async_io=True)
            mgr.save(1, tree)
            tree["a"].add_(1.0)   # the snapshot was taken at save()
            mgr.wait()
            assert mgr.latest_step() == 1
            np.testing.assert_array_equal(mgr.restore(1, like=tree)["a"].numpy(),
                                          np.arange(100.0, dtype=np.float32))

    def test_restore_placement_and_refusals(self):
        """Each leaf lands on the device of `like`'s leaf, in the file's
        dtype; a bfloat16 leaf and a tree of another size are refused."""
        tree = {"w": torch.arange(16.0).reshape(4, 4), "step": torch.tensor(3, dtype=torch.int32)}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, async_io=False)
            mgr.save(1, tree)
            out = mgr.restore(1, like={"w": torch.empty(0), "step": np.int32(0)})
            assert torch.equal(out["w"], tree["w"]) and out["step"].dtype == torch.int32
            with pytest.raises(ValueError):
                mgr.restore(1, like={"w": tree["w"]})
            with pytest.raises(TypeError, match="bfloat16"):
                mgr.save(2, {"w": tree["w"].bfloat16()})

    def test_train_state_restores_across_packages(self):
        """Port -> JAX and JAX -> port, with compression on (error buffer
        leaves) and off (an empty error buffer gives no leaves)."""
        cfg = get_config("stablelm-3b").reduced()
        jcfg = jget_config("stablelm-3b").reduced()
        for compress_grads in (False, True):
            tcfg = TrainConfig(dtype=torch.float32, compress_grads=compress_grads)
            jtcfg = JTrainConfig(dtype=jnp.float32, compress_grads=compress_grads)
            state = init_train_state(cfg, tcfg, GEN(), "cpu")
            state.opt.step.fill_(5)
            jstate = jinit_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
            mine, jleaves = leaves(state), jax.tree_util.tree_leaves(jstate)
            assert [tuple(x.shape) for x in mine] == [x.shape for x in jleaves]
            with tempfile.TemporaryDirectory() as d:
                CheckpointManager(d, async_io=False).save(3, state)
                back = JCheckpointManager(d, async_io=False).restore(3, like=jstate)
                assert back.opt.step.dtype == jnp.int32 and int(back.opt.step) == 5
                for a, b in zip(mine, jax.tree_util.tree_leaves(back)):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            with tempfile.TemporaryDirectory() as d:
                JCheckpointManager(d, async_io=False).save(4, jstate)
                back = CheckpointManager(d).restore(4, like=state)
                assert back.opt.step.dtype == torch.int32
                assert isinstance(back, type(state)) and set(back.params) == set(state.params)
                for a, b in zip(leaves(back), jleaves):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_flatten_order_is_jax_tree_util(self):
        from repro.optim.adamw import AdamWState as JState

        tree = {"z": (1, [2, 3]), "a": {"y": 4, "b": None, "c": {}},
                "s": adamw.AdamWState(5, {"q": 6, "p": 7}, 8)}
        jtree = dict(tree, s=JState(5, {"q": 6, "p": 7}, 8))
        flat, treedef = flatten(tree)
        assert flat == jax.tree_util.tree_leaves(jtree)
        assert treedef.unflatten(flat) == tree


class TestSupervisor:
    def _mk(self, d, fail_at=(), ckpt_every=5):
        cfg = get_config("stablelm-3b").reduced()
        tcfg = TrainConfig(microbatches=1, remat=False, dtype=torch.float32)
        data = SyntheticLM(cfg.vocab_size, 8, 4)
        step = make_train_step(cfg, tcfg)

        def make_state():
            return init_train_state(cfg, tcfg, GEN(), "cpu")

        def step_fn(state, idx):
            return step(state, data.batch_at(idx))

        ckpt = CheckpointManager(d, async_io=False)
        return Supervisor(
            make_state, step_fn, ckpt, ckpt_every=ckpt_every,
            failure_injector=FailureInjector(tuple(fail_at)),
        )

    def test_restart_resumes_from_checkpoint(self):
        with tempfile.TemporaryDirectory() as d:
            sup = self._mk(d, fail_at=(7,))
            sup.run(12)
            assert sup.restarts == 1
            steps_seen = [h["step"] for h in sup.history]
            # steps 5 and 6 are replayed after the failure at 7
            assert steps_seen.count(5) == 2 and steps_seen.count(6) == 2
            assert steps_seen[-1] == 11
            # the replay starts from the checkpoint: the same losses again
            first, again = [[h["loss"] for h in sup.history if h["step"] == s]
                            for s in (5, 6)]
            assert first[0] == first[1] and again[0] == again[1]

    def test_too_many_failures_raises(self):
        with tempfile.TemporaryDirectory() as d:
            sup = self._mk(d, fail_at=(0,))
            sup.max_restarts = 0
            # failing at step 0 repeatedly (fires once) then resumes
            with pytest.raises(SimulatedFailure):
                sup.inject.fired.clear()
                sup.max_restarts = -1
                sup.run(2)

    def test_straggler_detection(self):
        det = StragglerDetector(warmup=3, threshold_sigma=2.0)
        for i in range(10):
            det.observe(i, 0.10 + 0.001 * (i % 2))
        assert det.observe(10, 1.0) is True
        assert det.events[-1]["step"] == 10
        # baseline stays clean: a normal step afterwards is not flagged
        assert det.observe(11, 0.10) is False
