"""Finding a cell's files by name.

`BENCHMARK.json` names the cells, configurations and metrics; everything
that belongs to one of them lives in a file of its own, found by that name:
`benchmark/workloads/<cell>.json`, `benchmark/configs/<config>.json`,
`benchmark/traffic/<traffic>.json`, `benchmark/metrics/<metric>.py` and
`benchmark/rooflines/<function>*.json`. A later cell, configuration, metric
or roofline function is added by adding files.
"""

import ast
import glob
import importlib.util
import json
import os
import re
from typing import Dict

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _named(path_dir: str, name: str, suffix: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(path_dir, name + suffix)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def load_cell(name: str, root: str = ROOT) -> Dict:
    """The cell `name` with everything it needs: {"name", "entry": the
    workload file, "config": the configuration file, "traffic": the
    traffic file, "bench": its BENCHMARK.json entry, "end_to_end" and
    "per_layer": the metrics it reports}."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[name]
    bdir = os.path.join(root, "benchmark")
    cell = _json(_named(os.path.join(bdir, "workloads"), name, ".json"))
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(_named(os.path.join(bdir, "traffic"), w["traffic"],
                           ".json"))
    return {
        "name": name, "entry": cell, "config": config, "traffic": traffic,
        "bench": w,
        "end_to_end": [m for m in bench["end_to_end"] if reports(m, name)],
        "per_layer": [m for m in bench["per_layer"] if reports(m, name)],
    }


def reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str, root: str = ROOT):
    """The `read` function of `benchmark/metrics/<name>.py`."""
    path = _named(os.path.join(root, "benchmark", "metrics"), name, ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def rooflines(root: str = ROOT) -> Dict[str, Dict]:
    """Every roofline function, its files united: {function: {"formula",
    "patterns", "calls": {mode: [shape, ...]}}}. A later file for a
    function adds kernel-name patterns (a re-implementation) or calls."""
    out: Dict[str, Dict] = {}
    for path in sorted(glob.glob(os.path.join(root, "benchmark", "rooflines",
                                              "*.json"))):
        f = _json(path)
        fn = out.setdefault(f["function"], {"formula": None, "patterns": [],
                                            "calls": {}, "kernel": None})
        if f.get("formula"):
            fn["formula"] = f["formula"]
        if f.get("kernel"):
            fn["kernel"] = f["kernel"]
        fn["patterns"] += f.get("patterns", [])
        for mode, calls in f.get("calls", {}).items():
            fn["calls"].setdefault(mode, []).extend(calls)
    return out


_OPS = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant, ast.Name,
        ast.Load, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv,
        ast.Pow, ast.USub, ast.Call)


def evaluate(expr, names: Dict[str, float]) -> float:
    """An arithmetic expression over `names` (numbers, + - * / // **,
    min and max); a number is itself."""
    if isinstance(expr, (int, float)):
        return expr
    tree = ast.parse(str(expr), mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _OPS):
            raise ValueError(f"not arithmetic: {expr!r}")
        if isinstance(node, ast.Call) and not (
                isinstance(node.func, ast.Name)
                and node.func.id in ("min", "max")):
            raise ValueError(f"only min and max may be called: {expr!r}")
    return eval(compile(tree, "<shape>", "eval"),
                {"__builtins__": {}, "min": min, "max": max}, dict(names))


def shape_names(config: Dict, batch: int, valid_targets: float) -> Dict:
    """The names a roofline or FLOP expression may use, from the
    configuration's widths and the cell's batch."""
    m, d, t = config["model"], config["data"], config["text_encoder"]
    np_ = m["backbone_npoints"]
    ns = m["backbone_nsamples"]
    names = dict(
        B=batch, N=d["num_points"], L=d["max_text_len"], G=d["max_num_obj"],
        D=d["max_det_boxes"], Q=m["num_queries"], d=m["d_model"],
        H=m["num_heads"], Dh=m["d_model"] // m["num_heads"],
        FF=m["dim_feedforward"], enc=m["num_encoder_layers"],
        dec=m["num_decoder_layers"], P=m["num_decoder_layers"] + 1,
        C0=m["input_feature_dim"], NC=m["num_class"],
        rh=t["num_attention_heads"], rl=t["num_hidden_layers"],
        rd=t["hidden_size"], rff=t["intermediate_size"],
        rdh=t["hidden_size"] // t["num_attention_heads"], T=valid_targets)
    for i, (n, s) in enumerate(zip(np_, ns)):
        names[f"np{i}"] = n
        names[f"ns{i}"] = s
    return names
