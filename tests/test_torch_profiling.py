"""utils/profiling.py of the port on the CPU: time_fn counts its calls and
returns the last output, trace writes a Chrome trace."""
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
