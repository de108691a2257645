"""``BENCHMARK.json`` keeps the contract's form, and the harness finds
every piece it names by that name alone."""
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                    r"_rank$|head|expansion|per_tok|^d$)")


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(LINE.match(w) for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()


def test_configs():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        path = ROOT / c["file"]
        assert path.is_file() and path.is_relative_to(BENCH)
        conf = json.loads(path.read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf and key in conf["published"]
            assert not WIDTHS.search(key), key
        assert (BENCH / "configs" / f"{c['name']}.py").is_file()
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads():
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(names)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(names) // 4)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC[kind]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
        assert set(m) <= allowed and NAME.match(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert LINE.match(m["layer"]) and m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["name"].endswith("_roofline") or "mfu" in m["name"]
            assert m["unit"] == "%"
    assert "setup_s" in e2e


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in SPEC["workloads"]:
        def has(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = {m["name"] for m in SPEC["end_to_end"] if has(m)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in SPEC["per_layer"] if has(m)]
        assert layers and all(m["moves"] in e2e for m in layers)


def test_harness_names_no_cell_config_or_metric():
    words = {w["name"] for w in SPEC["workloads"]}
    words |= {w["traffic"] for w in SPEC["workloads"]}
    words |= {c["name"] for c in SPEC["configs"]}
    words |= {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for f in ("run.py", "harness.py", "trace.py", "card.py"):
        text = (BENCH / f).read_text()
        found = {w for w in words if re.search(rf"(?<![\w.-]){re.escape(w)}"
                                                rf"(?![\w-])", text)}
        assert not found, f"{f} names {found}"


def test_size():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
