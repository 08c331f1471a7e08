"""The profiler-trace reader behind ``tools/profile_step.py`` and
``tools/layer_profile.py``: device time is read from the GPU's stream
lines only, and busy time counts overlapping intervals once."""

import gzip
import json
import os

from tools.profile_step import busy_us, decode, device_events


def _meta(kind, pid, name, tid=None):
    e = {"ph": "M", "name": kind, "pid": pid, "args": {"name": name}}
    if tid is not None:
        e["tid"] = tid
    return e


def _x(pid, tid, ts, dur, name="fusion"):
    return {"ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "name": name}


def _write_trace(logdir, events):
    d = os.path.join(logdir, "plugins", "profile", "run0")
    os.makedirs(d)
    with gzip.open(os.path.join(d, "perfetto_trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_device_events_reads_only_gpu_stream_lines(tmp_path):
    _write_trace(str(tmp_path), [
        _meta("process_name", 1, "/device:GPU:0"),
        _meta("thread_name", 1, "Stream #13(Compute)", tid=7),
        _meta("thread_name", 1, "XLA Modules", tid=8),
        _meta("process_name", 2, "/host:CPU"),
        _meta("thread_name", 2, "python3", tid=9),
        _meta("process_name", 3, "GPU host threads"),
        _meta("thread_name", 3, "Stream launcher", tid=10),
        _x(1, 7, 100.0, 5.0, "loop_fusion"),
        _x(1, 7, 110.0, 2.0, "memcpy"),
        _x(1, 8, 90.0, 40.0, "jit_step"),   # module line: nests the same time
        _x(2, 9, 0.0, 500.0),               # host
        _x(3, 10, 100.0, 50.0),             # host side of the GPU
        {"ph": "i", "pid": 1, "tid": 7, "ts": 120.0, "name": "marker"},
    ])
    events, lines = device_events(str(tmp_path))
    assert lines == ["Stream #13(Compute)"]
    assert sorted(e["name"] for e in events) == ["loop_fusion", "memcpy"]
    assert busy_us(events) == 7.0


def test_busy_us_counts_overlap_once():
    evs = [_x(1, 1, 0.0, 10.0), _x(1, 2, 5.0, 10.0),   # 0-15 overlapped
           _x(1, 1, 15.0, 5.0),                        # touching: 0-20
           _x(1, 1, 30.0, 1.0), _x(1, 2, 30.5, 0.25)]  # 30-31 contains
    assert busy_us(evs) == 21.0
    assert busy_us([]) == 0.0


def test_decode_prints_busy_time_and_top_ops(tmp_path, capsys):
    _write_trace(str(tmp_path), [
        _meta("process_name", 1, "/device:GPU:0"),
        _meta("thread_name", 1, "Stream #13(Compute)", tid=7),
        _x(1, 7, 0.0, 3000.0, "gemm"), _x(1, 7, 4000.0, 1000.0, "fusion"),
        _x(1, 7, 6000.0, 3000.0, "gemm"), _x(1, 7, 9000.0, 1000.0, "fusion"),
    ])
    decode(str(tmp_path), iters=2)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device busy: 4.000 ms/iter (2 distinct ops")
    assert out[1].split()[:4] == ["3.000", "ms", "x1", "gemm"]
    assert out[2].split()[:4] == ["1.000", "ms", "x1", "fusion"]
