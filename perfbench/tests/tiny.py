"""A test-only cell, laid out as a checkout: a tiny configuration, a mix
with a pause, a cell file and one metric of its own beside copies of the
benchmark's readers.  The harness finds all of it by name."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny.swap"

CONFIG = {"source": "test only", "arch": "tiny", "hidden_size": 64,
          "intermediate_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "vocab_size": 256, "torch_dtype": "bfloat16",
          "rope_theta": 1e6, "rms_norm_eps": 1e-6, "max_batch": 4,
          "page_size": 4}
MIX = {"source": "test only",
       "prompt_tokens": {"dist": "log_uniform", "lo": 12, "hi": 40},
       "phases": [{"output_tokens": {"dist": "fixed", "value": 3},
                   "pause_s": {"dist": "uniform", "lo": 0.02, "hi": 0.06}},
                  {"output_tokens": {"dist": "uniform_int", "lo": 2,
                                     "hi": 4}}]}
PARAMS = {"rate_per_s": 12.0, "limits": {"served_logit_gap": 0.05}}
RAMP_S = 0.3                 # the harness's ramp and sample, cut to a test
SAMPLE_REQUESTS = 3
TEST_METRIC = '''"""Test only: the tokens of the window."""


def read(run):
    return float(run.tokens_in_window())
'''


def shorten(monkeypatch) -> None:
    """The harness's ramp and sample at the test's size."""
    from perfbench.harness import serve
    monkeypatch.setattr(serve, "RAMP_S", RAMP_S)
    monkeypatch.setattr(serve, "SAMPLE_REQUESTS", SAMPLE_REQUESTS)


def make_root(tmp: Path, params: dict | None = None) -> Path:
    base = tmp / "perfbench"
    for sub in ("configs", "traffic", "cells"):
        (base / sub).mkdir(parents=True)
    shutil.copytree(REPO / "perfbench" / "metrics", base / "metrics")
    (base / "metrics" / "tiny_tokens.py").write_text(TEST_METRIC)
    (base / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (base / "traffic" / "tiny-swap.json").write_text(json.dumps(MIX))
    (base / "cells" / f"{CELL}.json").write_text(json.dumps(params or PARAMS))
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = {"configs": [{"name": "tiny", "source": "test only",
                          "file": "perfbench/configs/tiny.json",
                          "reduced": [], "why": "test"}],
             "workloads": [{"name": CELL, "config": "tiny",
                            "traffic": "tiny-swap", "chips": 1,
                            "why": "test"}],
             "end_to_end": [dict(m, workloads=[CELL])
                            for m in real["end_to_end"]],
             "per_layer": [dict(m, workloads=[CELL])
                           for m in real["per_layer"]]
             + [{"name": "tiny_tokens", "unit": "tokens", "better": "higher",
                 "source": "host_clock", "layer": "test",
                 "moves": "output_tok_s", "workloads": [CELL]}]}
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
