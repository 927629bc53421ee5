"""BENCHMARK.json: loading it, its rules on names, units and
entries, and finding each cell's files by the names it gives.

Files are found by name and never listed in code, so a later change adds
a cell, a traffic mix, a configuration or a metric by adding files and
entries only:

- `benchmark/traffic/<traffic>.json`: the mix's parameters;
- `benchmark/data/<recipe>.py`: a data recipe, named in a configuration;
- `benchmark/end_to_end/<metric>.py`, `benchmark/metrics/<metric>.py`:
  one reader per metric;
- a configuration's file is the one its `file` entry names.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH_RE = re.compile(r"[A-Za-z0-9_./-]{1,200}")
TEXT_MAX = 200
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("host_clock", "device_trace")

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
PER_LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def valid_name(s) -> bool:
    return isinstance(s, str) and NAME_RE.fullmatch(s) is not None


def valid_unit(s) -> bool:
    return isinstance(s, str) and UNIT_RE.fullmatch(s) is not None


def valid_text(s) -> bool:
    """1 to 200 characters on one line, no tab."""
    return (isinstance(s, str) and 1 <= len(s) <= TEXT_MAX
            and not any(c in s for c in "\n\r\t"))


def _entry_keys(what: str, e: dict, required: set, optional=()) -> list:
    out = []
    missing = required - set(e)
    extra = set(e) - required - set(optional)
    if missing:
        out.append(f"{what}: missing {sorted(missing)}")
    if extra:
        out.append(f"{what}: keys not allowed {sorted(extra)}")
    return out


def _path_ok(p) -> bool:
    return (isinstance(p, str) and PATH_RE.fullmatch(p) is not None
            and not p.startswith("/") and ".." not in p.split("/"))


def problems(spec: dict) -> list[str]:
    """Every breach of BENCHMARK.json's static rules in `spec` (empty when
    it keeps them all)."""
    out: list[str] = []
    if set(spec) != TOP_KEYS:
        out.append(f"top-level keys {sorted(spec)} != {sorted(TOP_KEYS)}")
    paths = spec.get("paths", [])
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16
            and all(_path_ok(p) for p in paths)):
        out.append("paths: 1 to 16 relative paths of [A-Za-z0-9_./-]")
    cmd = spec.get("command", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32
            and all(valid_text(w) and not w.startswith("/")
                    and ".." not in w.split("/") for w in cmd)):
        out.append("command: 1 to 32 words, none absolute or leading out")
    rs = spec.get("run_seconds")
    if not (isinstance(rs, int) and not isinstance(rs, bool)
            and 1 <= rs <= 51):
        out.append("run_seconds: a whole number from 1 to 51")
    names: dict[str, set] = {"configs": set(), "workloads": set(),
                             "metrics": set()}
    configs = spec.get("configs", [])
    if not (isinstance(configs, list) and 1 <= len(configs) <= 24):
        out.append("configs: 1 to 24 entries")
        configs = []
    files = set()
    for c in configs:
        what = f"config {c.get('name')!r}"
        out += _entry_keys(what, c, CONFIG_KEYS)
        if not valid_name(c.get("name")):
            out.append(f"{what}: bad name")
        if c.get("name") in names["configs"]:
            out.append(f"{what}: name used twice")
        names["configs"].add(c.get("name"))
        for key in ("source", "why"):
            if not valid_text(c.get(key)):
                out.append(f"{what}: bad {key}")
        red = c.get("reduced", [])
        if not (isinstance(red, list) and len(red) <= 16
                and all(valid_name(k) for k in red)):
            out.append(f"{what}: reduced must list at most 16 names")
        f = c.get("file")
        if not _path_ok(f) or not any(
                f.startswith(p.rstrip("/") + "/") for p in paths):
            out.append(f"{what}: file must lie under paths")
        if f in files:
            out.append(f"{what}: file used by another configuration")
        files.add(f)
    cells = spec.get("workloads", [])
    if not (isinstance(cells, list) and 1 <= len(cells) <= 24):
        out.append("workloads: 1 to 24 entries")
        cells = []
    pairs = set()
    used_configs = set()
    for w in cells:
        what = f"workload {w.get('name')!r}"
        out += _entry_keys(what, w, WORKLOAD_KEYS)
        for key in ("name", "config", "traffic"):
            if not valid_name(w.get(key)):
                out.append(f"{what}: bad {key}")
        if w.get("name") in names["workloads"]:
            out.append(f"{what}: name used twice")
        names["workloads"].add(w.get("name"))
        if w.get("config") not in names["configs"]:
            out.append(f"{what}: unknown config")
        used_configs.add(w.get("config"))
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"{what}: configuration and traffic used twice")
        pairs.add(pair)
        if w.get("chips") not in (1, 4):
            out.append(f"{what}: chips must be 1 or 4")
        if not valid_text(w.get("why")):
            out.append(f"{what}: bad why")
    four = sum(w.get("chips") == 4 for w in cells)
    if four > max(1, len(cells) // 4):
        out.append("workloads: too many cells on 4 chips")
    for c in names["configs"] - used_configs:
        out.append(f"config {c!r}: used by no cell")
    e2e = spec.get("end_to_end", [])
    if not (isinstance(e2e, list) and 1 <= len(e2e) <= 16):
        out.append("end_to_end: 1 to 16 entries")
        e2e = []
    e2e_names = set()
    for m in e2e:
        what = f"end_to_end {m.get('name')!r}"
        out += _entry_keys(what, m, E2E_KEYS, ("workloads",))
        out += _metric_common(what, m, names, cells)
        if m.get("source") not in E2E_SOURCES:
            out.append(f"{what}: source must be host_clock or device_trace")
        b = m.get("bound")
        if not (isinstance(b, (int, float)) and 0 < b <= 0.25):
            out.append(f"{what}: bound must be in (0, 0.25]")
        e2e_names.add(m.get("name"))
    if "setup_s" not in e2e_names:
        out.append("end_to_end: setup_s is missing")
    per_layer = spec.get("per_layer", [])
    if not (isinstance(per_layer, list) and 1 <= len(per_layer) <= 128):
        out.append("per_layer: 1 to 128 entries")
        per_layer = []
    for m in per_layer:
        what = f"per_layer {m.get('name')!r}"
        out += _entry_keys(what, m, PER_LAYER_KEYS, ("workloads",))
        out += _metric_common(what, m, names, cells)
        if m.get("source") not in SOURCES:
            out.append(f"{what}: unknown source")
        if not valid_text(m.get("layer")):
            out.append(f"{what}: bad layer")
        if m.get("moves") not in e2e_names:
            out.append(f"{what}: moves no end-to-end metric")
        if m.get("name", "").endswith("_roofline") and m.get("unit") != "%":
            out.append(f"{what}: a roofline share is in %")
    for w in cells:
        name = w.get("name")
        mine = [m["name"] for m in e2e if applies(m, name)]
        if "setup_s" not in mine or len(mine) < 2:
            out.append(f"workload {name!r}: needs setup_s and one more "
                       f"end-to-end metric")
        if not any(applies(m, name) for m in per_layer):
            out.append(f"workload {name!r}: needs a per-layer metric")
    for m in per_layer:
        for name in m.get("workloads", []):
            moved = [e for e in e2e if e.get("name") == m.get("moves")]
            if moved and not applies(moved[0], name):
                out.append(f"per_layer {m.get('name')!r}: cell {name!r} "
                           f"does not report {m.get('moves')!r}")
    if len(json.dumps(spec).encode()) > 64 * 1024:
        out.append("BENCHMARK.json is larger than 64 KiB")
    return out


def _metric_common(what: str, m: dict, names: dict, cells: list) -> list:
    out = []
    if not valid_name(m.get("name")):
        out.append(f"{what}: bad name")
    if m.get("name") in names["metrics"]:
        out.append(f"{what}: name used twice")
    names["metrics"].add(m.get("name"))
    if not valid_unit(m.get("unit")):
        out.append(f"{what}: bad unit")
    if m.get("better") not in ("lower", "higher"):
        out.append(f"{what}: better must be lower or higher")
    if "workloads" in m:
        cell_names = {w.get("name") for w in cells}
        wl = m["workloads"]
        if not (isinstance(wl, list) and wl
                and all(n in cell_names for n in wl)):
            out.append(f"{what}: workloads must name cells")
    return out


def applies(metric: dict, cell_name: str) -> bool:
    """Whether `metric` is reported in the cell named `cell_name`."""
    wl = metric.get("workloads")
    return wl is None or cell_name in wl


def load(path: Path | None = None) -> dict:
    """BENCHMARK.json, refused with every problem named when it breaks
    its rules."""
    path = path or ROOT / "BENCHMARK.json"
    spec = json.loads(Path(path).read_text())
    bad = problems(spec)
    if bad:
        raise ValueError("BENCHMARK.json breaks its rules:\n  "
                         + "\n  ".join(bad))
    return spec


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(spec: dict, name: str) -> dict:
    """The configuration's file, as it is run."""
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration named {name!r}")


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def load_module(kind: str, name: str) -> ModuleType:
    """`benchmark/<kind>/<name>.py` as a module (names may hold dots,
    so it is loaded from its file and not by import path)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod_name = f"_perfbench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    mod_spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
