"""The port's training substrate (``repro_torch.train``,
``repro_torch.data.pipeline``, ``repro_torch.configs.base``,
``repro_torch.launch.train``) on the CPU: the tests of
``tests/test_train.py`` for the port, then its train steps and its
launcher against the reference's.

Differential tolerances.  The reduced LMs' microbatched step
(``lm_train_cell``'s, 2 microbatches, 3 steps) in f32: losses rtol=1e-6,
grad norms rtol=1e-5, parameters rtol=atol=1e-5 (largest difference
seen 3.5e-6).  In bf16: losses atol=1e-3 (seen 1.6e-4), grad norms
rtol=2e-3 (seen 7e-4), parameters atol=4e-3 (seen 1.6e-3: one or two
bf16 steps where the two packages round a bf16 gradient differently,
then AdamW moves the element by up to lr per step).  DLRM's train_step
(3 steps, f32): loss rtol=1e-6, grad norms rtol=1e-5, parameters as the
f32 LMs' (seen 3.0e-6 on 2 of 2,048 elements of one top-tower layer:
AdamW divides a gradient by its own root mean square, so a last-bit
difference in a small gradient moves the update by more than its
share), moments rtol=1e-5, atol=1e-9.  The
launcher's printed losses (4 decimals) must be equal.  The elastic-mesh
tests of ``test_train.py`` wait for the sharding pieces.
"""
import contextlib
import dataclasses
import io
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import lm_train_cell, make_dlrm_arch
from repro.configs.dlrm_mlperf import REDUCED as REDUCED_J
from repro.configs.registry import get_arch as j_get_arch
from repro.models import dlrm as JD
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch.configs import base as B
from repro_torch.configs.dlrm_mlperf import REDUCED
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import ShardedPipeline
from repro_torch.data.synthetic import dlrm_batch, lm_batch
from repro_torch.kernels.embedding_bag import kernel as k3
from repro_torch.kernels.flash_attention import kernel as k4
from repro_torch.launch import train as launch_train
from repro_torch.models import dlrm as D
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.fault_tolerance import (PreemptionGuard,
                                               StragglerPolicy,
                                               run_step_with_retry)
from repro_torch.train.trainer import TrainLoopConfig, train_loop

CPU = torch.device("cpu")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "h": torch.randn((5, 3), generator=g).to(torch.bfloat16),
            "b": {"w": torch.arange(10, dtype=torch.int32),
                  "s": np.float32(3.5 + seed)}}


def _leaves(tree):
    return [(p, x) for p, x in sorted(_paths(tree).items())]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


def _equal(a, b):
    a = a.view(torch.int16) if torch.is_tensor(a) and a.dtype == \
        torch.bfloat16 else a
    b = b.view(torch.int16) if torch.is_tensor(b) and b.dtype == \
        torch.bfloat16 else b
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else
            (torch.zeros_like(v) if torch.is_tensor(v) else np.float32(0))
            for k, v in tree.items()}


class TestCheckpoint:
    def test_roundtrip_bit_for_bit_with_bf16_leaves(self, tmp_path):
        t = _tree()
        save_checkpoint(tmp_path, 7, t, extra={"note": "x"})
        like = _zeros_like(t)
        restored, step, extra = restore_checkpoint(tmp_path, like)
        assert step == 7 and extra == {"note": "x"}
        assert restored["a"] is like["a"]          # filled in place
        assert restored["h"].dtype == torch.bfloat16
        for (_, a), (_, b) in zip(_leaves(t), _leaves(restored)):
            _equal(a, b)

    def test_manifest_names_bf16_and_stores_raw_words(self, tmp_path):
        import json
        t = _tree()
        d = save_checkpoint(tmp_path, 1, t)
        man = json.loads((d / "manifest.json").read_text())
        by_path = {m["path"]: m for m in man["leaves"]}
        assert by_path["h"]["dtype"] == "bfloat16"
        assert by_path["b/w"]["dtype"] == "int32"
        with np.load(d / "shard_0.npz") as z:
            words = z[f"leaf_{list(by_path).index('h')}"]
        assert words.dtype == np.uint16
        np.testing.assert_array_equal(
            words.view(np.int16), t["h"].view(torch.int16).numpy())

    def test_module_leaves_take_state_dict_names(self, tmp_path):
        lin = torch.nn.Linear(3, 2)
        st = A.adamw_init(lin)
        d = save_checkpoint(tmp_path, 0, (lin, st))
        import json
        paths = [m["path"] for m in
                 json.loads((d / "manifest.json").read_text())["leaves"]]
        assert paths == ["0/weight", "0/bias", "1/mu/weight", "1/mu/bias",
                         "1/nu/weight", "1/nu/bias", "1/step"]
        lin2 = torch.nn.Linear(3, 2)
        restore_checkpoint(tmp_path, (lin2, A.adamw_init(lin2)))
        _equal(lin2.weight.detach(), lin.weight.detach())

    def test_latest_and_multiple(self, tmp_path):
        for s in (1, 5, 3):
            save_checkpoint(tmp_path, s, _tree(s))
        assert latest_step(tmp_path) == 5
        restored, step, _ = restore_checkpoint(tmp_path, _zeros_like(_tree()),
                                               step=3)
        assert step == 3
        _equal(restored["a"], _tree(3)["a"])
        assert (tmp_path / "latest").resolve().name == "step_00000003"

    def test_no_partial_visible(self, tmp_path):
        (tmp_path / ".tmp_step_00000009").mkdir()
        save_checkpoint(tmp_path, 2, _tree())
        assert latest_step(tmp_path) == 2
        assert not list(tmp_path.glob(".tmp_step_00000002"))

    def test_async(self, tmp_path):
        ck = AsyncCheckpointer(tmp_path)
        t = _tree()
        ck.save(1, t)
        ck.save(2, _tree(1))  # waits for the previous one
        t["a"].add_(1.0)      # the save holds a host copy, not a view
        ck.wait()
        assert latest_step(tmp_path) == 2
        restored, _, _ = restore_checkpoint(tmp_path, _zeros_like(t), step=1)
        _equal(restored["a"], _tree()["a"])

    def test_restore_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(tmp_path, _tree())

    @pytest.mark.parametrize("change", ["count", "names", "shape"])
    def test_wrong_leaves_raise(self, tmp_path, change):
        save_checkpoint(tmp_path, 1, _tree())
        like = _zeros_like(_tree())
        if change == "count":
            like["extra"] = torch.zeros(2)
        elif change == "names":
            like["z"] = like.pop("a")
        else:
            like["a"] = torch.zeros(16, 8)
        before = {k: v.clone() for k, v in like.items() if torch.is_tensor(v)}
        with pytest.raises(ValueError):
            restore_checkpoint(tmp_path, like)
        for k, v in before.items():      # nothing was written
            _equal(like[k], v)


class TestFaultTolerance:
    def test_retry_then_succeed(self):
        calls = {"n": 0}

        def flaky(x):
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("transient link flap")
            return x + 1

        seen = []
        out = run_step_with_retry(flaky, 1, max_retries=5, backoff_s=0.0,
                                  on_retry=lambda a, e: seen.append(a))
        assert out == 2 and calls["n"] == 3 and seen == [1, 2]

    def test_retry_exhausted(self):
        calls = {"n": 0}

        def always(x):
            calls["n"] += 1
            raise torch.OutOfMemoryError("dead")

        with pytest.raises(torch.OutOfMemoryError):
            run_step_with_retry(always, 1, max_retries=2, backoff_s=0.0)
        assert calls["n"] == 3

    def test_other_errors_are_not_retried(self):
        calls = {"n": 0}

        def bad(x):
            calls["n"] += 1
            raise KeyError(x)

        with pytest.raises(KeyError):
            run_step_with_retry(bad, 1, max_retries=5, backoff_s=0.0)
        assert calls["n"] == 1

    def test_not_implemented_is_not_retried(self):
        calls = {"n": 0}

        def missing(x):
            calls["n"] += 1
            raise NotImplementedError("not ported")

        with pytest.raises(NotImplementedError):
            run_step_with_retry(missing, 1, max_retries=5, backoff_s=10.0)
        assert calls["n"] == 1

    def test_straggler_detection(self):
        sp = StragglerPolicy(window=16, threshold=2.0, patience=2)
        for _ in range(10):
            v = sp.observe(1.0)
        assert not v["slow"]
        v = sp.observe(5.0)
        assert v["slow"] and not v["redispatch"]
        v = sp.observe(5.0)
        assert v["redispatch"]

    def test_preemption_guard_flag(self):
        g = PreemptionGuard(signals=())
        assert not g.preempted
        g._handler(None, None)
        assert g.preempted

    def test_preemption_guard_catches_sigterm(self):
        previous = signal.getsignal(signal.SIGTERM)
        g = PreemptionGuard()
        try:
            signal.raise_signal(signal.SIGTERM)
            assert g.preempted
        finally:
            g.restore()
        assert signal.getsignal(signal.SIGTERM) == previous


class TestPipeline:
    def test_ordered_and_deterministic(self):
        p = ShardedPipeline(lambda s: lm_batch(s, 2, 8, 100), depth=2)
        got = [next(p) for _ in range(4)]
        p.close()
        assert [s for s, _ in got] == [0, 1, 2, 3]
        again = lm_batch(2, 2, 8, 100)
        np.testing.assert_array_equal(got[2][1]["tokens"], again["tokens"])

    def test_start_step_replays(self):
        p = ShardedPipeline(lambda s: lm_batch(s, 2, 8, 100), start_step=5)
        step, batch = next(p)
        p.close()
        assert step == 5
        np.testing.assert_array_equal(batch["labels"],
                                      lm_batch(5, 2, 8, 100)["labels"])

    def test_a_failing_batch_raises_in_the_consumer(self):
        def make(s):
            if s == 1:
                raise ValueError("bad shard")
            return s

        p = ShardedPipeline(make)
        assert next(p) == (0, 0)
        with pytest.raises(ValueError, match="bad shard"):
            next(p)
        p.close()


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------
def _toy():
    dim = 16

    def loss_fn(p, b):
        pred = torch.as_tensor(b["x"]) @ p["w"]
        return torch.mean((pred - torch.as_tensor(b["y"])) ** 2)

    def step(params, opt_state, batch):
        for t in params.values():
            t.requires_grad_(True)
        loss = loss_fn(params, batch)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        p, o, gn = A.adamw_update(grads, opt_state, params,
                                  A.AdamWConfig(lr=1e-2))
        return p, o, {"loss": loss.detach()}

    def make_batch(s):
        rng = np.random.default_rng(s)
        x = rng.standard_normal((8, dim)).astype(np.float32)
        return {"x": x, "y": (x.sum(1, keepdims=True) * 0.1)}

    return step, {"w": torch.zeros((dim, 1))}, make_batch


class TestTrainLoop:
    def test_loss_decreases_and_resumes(self, tmp_path):
        step, params, make_batch = _toy()
        cfg = TrainLoopConfig(total_steps=30, checkpoint_every=10,
                              checkpoint_dir=str(tmp_path))
        p1, o1, hist = train_loop(step, params, make_batch, cfg)
        assert hist[-1]["loss"] < hist[0]["loss"]
        assert set(hist[0]) == {"step", "seconds", "loss", "straggler"}
        cfg2 = TrainLoopConfig(total_steps=45, checkpoint_every=10,
                               checkpoint_dir=str(tmp_path))
        _, fresh, _ = _toy()
        p2, o2, hist2 = train_loop(step, fresh, make_batch, cfg2)
        assert hist2[0]["step"] == 30
        assert hist2[-1]["step"] == 44
        assert int(o2["step"]) == 45

    def test_log_cadence(self):
        step, params, make_batch = _toy()
        rows = []
        train_loop(step, params, make_batch,
                   TrainLoopConfig(total_steps=12, log_every=5),
                   log_fn=rows.append)
        assert [r["step"] for r in rows] == [0, 5, 10]

    def test_killed_run_resumes_bit_identical(self, tmp_path):
        """A run killed at step 23 (a BaseException, not retried) resumes
        from its step-19 checkpoint and ends bit for bit where an
        uninterrupted run ends."""
        step, params, make_batch = _toy()
        train_loop(step, params, make_batch, TrainLoopConfig(total_steps=30))
        ref_w = params["w"].detach().clone()

        class Killed(BaseException):
            pass

        def dying(p, o, b):
            if int(o["step"]) == 23:
                raise Killed
            return step(p, o, b)

        _, p1, _ = _toy()
        cfg = TrainLoopConfig(total_steps=30, checkpoint_every=10,
                              checkpoint_dir=str(tmp_path))
        with pytest.raises(Killed):
            train_loop(dying, p1, make_batch, cfg)
        assert latest_step(tmp_path) == 19
        _, p2, _ = _toy()
        _, o2, hist = train_loop(step, p2, make_batch, cfg)
        assert hist[0]["step"] == 20 and int(o2["step"]) == 30
        _equal(p2["w"].detach(), ref_w)

    def test_preemption_saves_and_stops(self, tmp_path):
        step, params, make_batch = _toy()

        def preempting(p, o, b):
            if int(o["step"]) == 6:
                signal.raise_signal(signal.SIGTERM)
            return step(p, o, b)

        cfg = TrainLoopConfig(total_steps=30, checkpoint_every=100,
                              checkpoint_dir=str(tmp_path))
        _, _, hist = train_loop(preempting, params, make_batch, cfg)
        assert hist[-1]["step"] == 6 and latest_step(tmp_path) == 6


@pytest.mark.parametrize("where", ["forward", "backward", "optimizer",
                                   "scratch"])
def test_a_step_that_fails_once_ends_equal_to_a_clean_run(where,
                                                          monkeypatch):
    """The DLRM step raises once (a RuntimeError, as the card's
    transient faults are) in its forward, its backward, AdamW's norm or
    the allocation of AdamW's scratch (out of memory); the loop retries
    it, and the parameters and the state end bit for bit equal to a run
    without the fault: nothing was written before the failure."""
    def run():
        params = D.init_dlrm(REDUCED, torch.Generator().manual_seed(0),
                             "cpu")
        step = B.dlrm_train_step(REDUCED, device="cpu")

        def make_batch(s):
            return dlrm_batch(s, 32, REDUCED.vocab_sizes)

        _, opt, hist = train_loop(step, params, make_batch,
                                  TrainLoopConfig(total_steps=4))
        return params, opt, hist

    clean_p, clean_o, clean_h = run()
    state = {"fired": False}

    class FailingBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            state["fired"] = True
            raise RuntimeError("transient fault in the backward")

    def once(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if not state["fired"] and state.get("calls", 0) == 2:
                if where == "forward":
                    state["fired"] = True
                    raise RuntimeError("transient fault in the forward")
                if where == "backward":
                    out = FailingBackward.apply(out)
                if where == "optimizer":
                    state["fired"] = True
                    raise RuntimeError("transient fault in the optimizer")
                if where == "scratch":
                    state["fired"] = True
                    raise torch.OutOfMemoryError("out of memory")
            state["calls"] = state.get("calls", 0) + 1
            return out
        return wrapped

    if where == "optimizer":
        monkeypatch.setattr(A, "global_norm", once(A.global_norm))
    elif where == "scratch":
        monkeypatch.setattr(A, "_scratch", once(A._scratch))
    else:
        monkeypatch.setattr(B, "dlrm_loss", once(B.dlrm_loss))
    monkeypatch.setattr("repro_torch.train.fault_tolerance.time.sleep",
                        lambda s: None)
    p, o, h = run()
    assert state["fired"]
    assert [r["loss"] for r in h] == [r["loss"] for r in clean_h]
    assert int(o["step"]) == int(clean_o["step"]) == 4
    for (n, a), (_, b) in zip(p.named_parameters(),
                              clean_p.named_parameters()):
        _equal(a.detach(), b.detach())
        _equal(o["mu"][n], clean_o["mu"][n])
        _equal(o["nu"][n], clean_o["nu"][n])


def test_an_update_that_fails_after_a_write_is_not_retried(monkeypatch):
    """AdamW's write of the second leaf raises (out of memory, a
    RuntimeError): the first leaf is already written, so the loop must
    not run the step again.  The error comes out as
    ``PartialUpdateError`` with the fault as its cause, after one
    attempt, and the step counter is not advanced."""
    params = D.init_dlrm(REDUCED, torch.Generator().manual_seed(0), "cpu")
    step = B.dlrm_train_step(REDUCED, device="cpu")
    first = next(iter(params.parameters())).detach().clone()
    calls = {"step": 0, "leaf": 0}
    real = A._update_leaf

    def failing(*a, **k):
        calls["leaf"] += 1
        if calls["leaf"] == 2:
            raise torch.OutOfMemoryError("out of memory")
        return real(*a, **k)

    def counted(*a):
        calls["step"] += 1
        return step(*a)

    monkeypatch.setattr(A, "_update_leaf", failing)
    monkeypatch.setattr("repro_torch.train.fault_tolerance.time.sleep",
                        lambda s: None)
    opt = A.adamw_init(params)
    with pytest.raises(A.PartialUpdateError) as info:
        train_loop(counted, params,
                   lambda s: dlrm_batch(s, 32, REDUCED.vocab_sizes),
                   TrainLoopConfig(total_steps=2), opt_state=opt)
    assert isinstance(info.value.__cause__, torch.OutOfMemoryError)
    assert calls == {"step": 1, "leaf": 2} and int(opt["step"]) == 0
    assert not torch.equal(next(iter(params.parameters())).detach(), first)


# ---------------------------------------------------------------------------
# the train steps against the reference's cells
# ---------------------------------------------------------------------------
def _lm_pair(name, dtype):
    jcfg = dataclasses.replace(j_get_arch(name).reduced_cfg,
                               param_dtype=dtype, ce_chunk=16)
    cfg = dataclasses.replace(get_arch(name).reduced_cfg, param_dtype=dtype,
                              ce_chunk=16)
    jp = JT.init_lm(jax.random.key(0), jcfg)
    port = T.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")
    return jcfg, cfg, jp, port


def _lm_leaf(tree, name):
    parts = name.split(".")
    if parts[0] == "blocks":
        node = tree["blocks"]
        for k in parts[2:]:
            node = node[k]
        return np.asarray(node[int(parts[1])], np.float32)
    for k in parts:
        tree = tree[k]
    return np.asarray(tree, np.float32)


LM_STEP_TOL = {"float32": dict(loss=dict(rtol=1e-6, atol=0),
                               gnorm=dict(rtol=1e-5, atol=0),
                               params=dict(rtol=1e-5, atol=1e-5)),
               "bfloat16": dict(loss=dict(rtol=0, atol=1e-3),
                                gnorm=dict(rtol=2e-3, atol=0),
                                params=dict(rtol=0, atol=4e-3))}


@pytest.mark.parametrize("name,dtype", [("starcoder2-7b", "float32"),
                                        ("command-r-35b", "float32"),
                                        ("starcoder2-7b", "bfloat16")])
def test_microbatched_lm_step_matches_the_reference_cell(name, dtype):
    jcfg, cfg, jp, port = _lm_pair(name, dtype)
    cell = lm_train_cell(jcfg, "t", 4, 32, JT.train_forward, microbatches=2)
    jstep = jax.jit(cell.step)
    step = B.lm_train_step(cfg, 4, 32, microbatches=2, device="cpu")
    jo, to = JA.adamw_init(jp), A.adamw_init(port)
    tol = LM_STEP_TOL[dtype]
    for s in range(3):
        b = lm_batch(s, 4, 32, cfg.vocab)
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        port, to, tm = step(port, to, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **tol["loss"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **tol["gnorm"])
    jpn = jax.tree.map(np.asarray, jp)
    for n, p in port.named_parameters():
        assert p.dtype == cfg.dtype
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   _lm_leaf(jpn, n), **tol["params"],
                                   err_msg=n)


def test_lm_step_rejects_a_ragged_microbatch_split():
    cfg = get_arch("starcoder2-7b").reduced_cfg
    with pytest.raises(ValueError):
        B.lm_train_step(cfg, 6, 32, microbatches=4, device="cpu")


def _dlrm_leaf(tree, name):
    if name.startswith("table_"):
        return np.asarray(tree["tables"][int(name[6:])])
    tower, _, i, k = name.split(".")
    return np.asarray(tree[tower]["layers"][int(i)][k])


def test_dlrm_train_step_matches_the_reference_cell():
    jstep = jax.jit(make_dlrm_arch("dlrm", REDUCED_J, REDUCED_J)
                    .cells["train_batch"].step)
    jp = JD.init_dlrm(jax.random.key(0), REDUCED_J)
    port = D.dlrm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    step = B.dlrm_train_step(REDUCED, device="cpu")
    jo, to = JA.adamw_init(jp), A.adamw_init(port)
    for s in range(3):
        b = dlrm_batch(s, 64, REDUCED.vocab_sizes)
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        port, to, tm = step(port, to, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    jpn = jax.tree.map(np.asarray, jp)
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _dlrm_leaf(jpn, n),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
        np.testing.assert_allclose(to["mu"][n].numpy(),
                                   _dlrm_leaf(jax.tree.map(np.asarray,
                                                           jo["mu"]), n),
                                   rtol=1e-5, atol=1e-9, err_msg=n)


def test_train_steps_launch_neither_k3_nor_k4(monkeypatch):
    """A train step never reaches the K3 or K4 wrapper (on the card they
    would launch the kernels, which have no backward)."""
    def forbidden(*a, **k):
        raise AssertionError("a kernel wrapper was called in a train step")

    for mod, name in ((k3, "embag_tables"), (k3, "embag"),
                      (k4, "flash_attention")):
        monkeypatch.setattr(mod, name, forbidden)
    monkeypatch.setattr("repro_torch.kernels.embedding_bag.ops.embag_tables",
                        forbidden)
    monkeypatch.setattr("repro_torch.models.layers.flash_attention",
                        forbidden)
    params = D.init_dlrm(REDUCED, torch.Generator().manual_seed(0), "cpu")
    B.dlrm_train_step(REDUCED, device="cpu")(
        params, A.adamw_init(params), dlrm_batch(0, 16, REDUCED.vocab_sizes))
    cfg = get_arch("starcoder2-7b").reduced_cfg
    lm = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    B.lm_train_step(cfg, 2, 16, device="cpu")(
        lm, A.adamw_init(lm), lm_batch(0, 2, 16, cfg.vocab))


# ---------------------------------------------------------------------------
# the launcher against the reference's
# ---------------------------------------------------------------------------
def _reference_main(argv):
    import repro.launch.train as JTR
    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["train"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            JTR.main()
    finally:
        sys.argv = old
    return buf.getvalue()


def _losses(text):
    out = []
    for line in text.splitlines():
        if line.startswith("step"):
            out.append(line.split("loss")[1].split()[0])
        elif line.startswith("done"):
            out.append(line.split("loss")[1].strip())
    return out


@pytest.mark.parametrize("name", ["dlrm-mlperf", "starcoder2-7b"])
def test_launcher_prints_the_reference_losses(name, capsys):
    want = _losses(_reference_main(["--arch", name, "--steps", "11"]))
    ja = j_get_arch(name)
    jp = jax.tree.map(np.asarray, ja.init_params(jax.random.key(0),
                                                 ja.reduced_cfg))
    cfg = get_arch(name).reduced_cfg
    params = (D.dlrm_params_from_jax(jp, device="cpu") if "dlrm" in name
              else T.lm_params_from_jax(jp, cfg, device="cpu"))
    capsys.readouterr()
    hist = launch_train.train(name, steps=11, device="cpu", params=params)
    got = _losses(capsys.readouterr().out)
    assert len(want) == 3 and got == want
    assert len(hist) == 11


def test_launcher_main_on_the_cpu(capsys, tmp_path):
    hist = launch_train.main(["--arch", "dlrm-mlperf", "--steps", "4",
                              "--device", "cpu", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("step     0  loss ")
    assert out.splitlines()[-1].startswith("done: loss ")
    assert len(hist) == 4 and latest_step(tmp_path) == 3
    # a second run resumes after the last checkpoint: nothing left to do
    assert launch_train.main(["--arch", "dlrm-mlperf", "--steps", "4",
                              "--device", "cpu", "--ckpt",
                              str(tmp_path)]) == []


@pytest.mark.parametrize("name", ["pna", "qwen3-moe-235b-a22b"])
def test_launcher_raises_for_unported_families(name):
    """No family is left unported: the GNN and MoE families, which raised
    ``NotImplementedError`` before, train (2 steps, finite losses; torch
    on one intra-op thread, restored after, since these small models'
    ops crawl on a pool of 8 threads when other test processes share the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        hist = launch_train.main(["--arch", name, "--device", "cpu",
                                  "--steps", "2", "--seq", "16"])
    finally:
        torch.set_num_threads(threads)
    assert len(hist) == 2 and all(np.isfinite(r["loss"]) for r in hist)


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "dlrm-mlperf", "--steps", "1"])


def test_registry_arch_has_init_params():
    for name, init in (("dlrm-mlperf", D.init_dlrm),
                       ("starcoder2-7b", T.init_lm)):
        arch = get_arch(name)
        assert arch.init_params is init
        params = arch.init_params(arch.reduced_cfg,
                                  torch.Generator().manual_seed(0), "cpu")
        assert all(not p.requires_grad for p in params.parameters())
