"""utils/profiling.py of the port on the CPU: time_fn counts its calls and
returns the last output, trace writes a Chrome trace, start_server captures
one; the program's spans are recorded only under a profiler, nest as the
steps and the model open them, lie on the profiler's clock, change no
number, and keep the newest records."""
import contextlib
import json
import os

import pytest
import torch

from multimodal_gar_tpu_torch.utils.profiling import time_fn, trace


@pytest.mark.parametrize("iters, warmup", [(1, 0), (3, 2)])
def test_time_fn_calls_and_returns(iters, warmup):
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return torch.full((2,), float(len(calls))) * scale

    seconds, out = time_fn(fn, 5, iters=iters, warmup=warmup, device="cpu",
                           scale=2.0)
    assert len(calls) == iters + warmup
    assert seconds > 0.0
    assert torch.equal(out, torch.full((2,), 2.0 * (iters + warmup)))


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.ones((16, 16))
    with trace(str(tmp_path / "prof"), name="mm", device="cpu") as prof:
        (a @ a).sum().item()
    path = tmp_path / "prof" / "mm.json"
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="needs a host without a card")
@pytest.mark.parametrize("which", ["time_fn", "trace"])
def test_no_card_raises_unless_cpu_is_asked(which, tmp_path):
    """Neither timer carries on on the host clock when it finds no card."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if which == "time_fn":
            time_fn(lambda: None, iters=1, warmup=0)
        else:
            with trace(str(tmp_path / "prof")):
                pass


def test_start_server_captures_a_trace_on_request(tmp_path):
    """start_server on the CPU: an ephemeral port, one local request for a
    50 ms capture while the main thread computes, a trace file written and
    named in the reply, then the serving thread stopped."""
    import threading
    import time
    import urllib.request

    from multimodal_gar_tpu_torch.utils.profiling import start_server
    t0 = time.perf_counter()
    server = start_server(0, logdir=str(tmp_path / "live"), device="cpu")
    port = server.server_address[1]
    reply = {}

    def ask():
        with urllib.request.urlopen(
                f"http://localhost:{port}/capture?ms=50", timeout=10) as r:
            reply.update(json.load(r))
    asker = threading.Thread(target=ask)
    asker.start()
    a = torch.ones((32, 32))
    while asker.is_alive():
        (a @ a).sum().item()
    asker.join()
    serving = [t for t in threading.enumerate()
               if t.name == "profiler-server"]
    server.shutdown()
    server.server_close()
    assert reply["ms"] == 50.0
    assert os.path.dirname(reply["trace"]) == str(tmp_path / "live")
    with open(reply["trace"]) as f:
        assert "traceEvents" in json.load(f)
    for t in serving:
        t.join(timeout=5)
        assert not t.is_alive()
    assert time.perf_counter() - t0 < 5.0


# the program's spans (utils/profiling.py: span) and each one's parent
MODEL_SPANS = {"mgar.rgb": None, "rgb.i3d": "mgar.rgb",
               "rgb.box_head": "mgar.rgb", "mgar.lidar": None,
               "lidar.vfe": "mgar.lidar",
               "lidar.sparse_backbone": "mgar.lidar",
               "lidar.grid_pool": "mgar.lidar", "lidar.embed": "mgar.lidar",
               "mgar.fusion": None, "fusion.dafm": "mgar.fusion",
               "fusion.heads": "mgar.fusion"}


def step_spans(loop):
    """Each span of one eval request or train micro-step -> its parent, in
    the order the spans open."""
    top = "eval_step" if loop == "eval" else "train_step.forward"
    model = {k: v or top for k, v in MODEL_SPANS.items()}
    if loop == "eval":
        return {"eval_step": None, **model}
    return {"train_step": None, "train_step.forward": "train_step",
            **model, **{f"train_step.{k}": "train_step"
                        for k in ("losses", "backward", "guard", "update")}}


def tiny_steps(grad_accum=8):
    """A tiny MGAR on the CPU, its eval step, a train step (Adam every
    ``grad_accum``-th call) and a batch."""
    from multimodal_gar_tpu_torch.models import MGAR
    from multimodal_gar_tpu_torch.train.train_state import (
        make_eval_step, make_optimizer, make_train_step)
    from multimodal_gar_tpu_torch.utils.testing import (
        batch_from_numpy, synthetic_batch_numpy, tiny_config)
    cfg = tiny_config()
    model = MGAR(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), cfg.train.stages[0], 8,
                         grad_accum, cfg.train.lr_decay_gamma)
    batch = batch_from_numpy(synthetic_batch_numpy(cfg, batch_size=1))
    return model, {"eval": make_eval_step(model),
                   "train": make_train_step(model, opt, "L_total",
                                            seed=5)}, batch


def cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_no_span_is_recorded_without_a_profiler():
    from multimodal_gar_tpu_torch.utils.profiling import (reset_spans,
                                                          span_records)
    _, steps, batch = tiny_steps()
    reset_spans()
    steps["eval"](batch)
    steps["train"](batch)
    assert span_records() == ([], 0)


@pytest.mark.parametrize("loop", ["eval", "train"])
def test_spans_nest_on_the_profilers_clock(loop):
    """Under a CPU profiler every span of the step is recorded once, under
    its parent, all with one root number; the profiler holds a range of
    each name, each child's range inside a range of its parent's, and every
    aten op of the step inside the step's root range."""
    from multimodal_gar_tpu_torch.utils.profiling import (reset_spans,
                                                          span_records)
    _, steps, batch = tiny_steps()
    want = step_spans(loop)
    reset_spans()
    with cpu_profile() as prof:
        steps[loop](batch)
        steps[loop](batch)
    recs = span_records().records
    assert [r["name"] for r in recs[:len(recs) // 2]] == list(want)
    assert [r["name"] for r in recs[len(recs) // 2:]] == list(want)
    assert {r["name"]: r["parent"] for r in recs} == want
    roots = [r["root"] for r in recs]
    assert len(set(roots[:len(want)])) == 1 == len(set(roots[len(want):]))
    assert roots[0] < roots[-1]
    assert all(r["device_ms"] is None and r["host_ms"] > 0 for r in recs)

    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))
    for name, parent in want.items():
        assert len(ranges[name]) == 2, name
        if parent is None:
            continue
        for s, e in ranges[name]:
            assert any(ps <= s and e <= pe for ps, pe in ranges[parent]), \
                (name, parent)
    root = next(n for n, p in want.items() if p is None)
    aten = [r for n, rs in ranges.items() if n.startswith("aten::")
            for r in rs]
    assert aten
    for s, e in aten:
        assert any(rs <= s and e <= re for rs, re in ranges[root])


def test_a_profiler_changes_no_number():
    """One micro-step (Adam applied: k = 1) and one request from the same
    state and seed, without and with a profiler: equal metrics, outputs,
    parameters and statistics, bit for bit."""
    runs = []
    for traced in (False, True):
        model, steps, batch = tiny_steps(grad_accum=1)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        with cpu_profile() if traced else contextlib.nullcontext():
            metrics = steps["train"](batch)
            out = steps["eval"](batch)
        state = model.state_dict()
        assert not torch.equal(state["rgb_backbone.embedding.weight"],
                               before["rgb_backbone.embedding.weight"])
        runs.append((metrics, out, state))
    (m0, o0, s0), (m1, o1, s1) = runs
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for k in ("a_theta", "card", "group_ids", "fused_features"):
        assert torch.equal(getattr(o0, k), getattr(o1, k)), k
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_the_span_buffer_keeps_the_newest_and_counts_the_dropped():
    from multimodal_gar_tpu_torch.utils.profiling import (
        SPAN_CAPACITY, reset_spans, span, span_records)
    reset_spans()
    with cpu_profile():
        for i in range(SPAN_CAPACITY + 5):
            with span(f"s{i}"):
                pass
    got = span_records()
    assert got.dropped == 5 and len(got.records) == SPAN_CAPACITY
    assert got.records[0]["name"] == "s5"
    assert got.records[-1]["name"] == f"s{SPAN_CAPACITY + 4}"
    roots = [r["root"] for r in got.records]
    assert roots == sorted(set(roots))          # each a root of its own
    reset_spans()
    assert span_records() == ([], 0)
