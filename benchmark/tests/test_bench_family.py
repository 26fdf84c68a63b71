"""A configuration whose train step is not SC-Depth's joins as files and
entries alone. A throwaway family (``toy``: one convolution that predicts
the target frame from its two references, its own reference, FLOP count,
launch shapes and kernel bytes), a configuration, a mix, limits and a cell
are written into a copy of the checkout whose harness files are left as
they are. The copy's own harness runs the cell on the CPU: correct, and not
correct with a fault planted in the family's program."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import spec
from benchmark.tests import tiny

HERE = os.path.join(spec.ROOT, "benchmark")

PROGRAM = '''
import torch

from benchmark.weights import init_weights


def build(cfg, traffic, seed, device):
    net = torch.nn.ModuleDict({"predict": torch.nn.Conv2d(6, 3, 3, padding=1)}).to(device)
    init_weights({"toy": net}, seed, device)
    named = [(f"toy.{n}", p) for n, p in net.named_parameters()]
    opt = torch.optim.Adam(net.parameters(), lr=cfg["lr"], betas=(cfg["momentum"], cfg["beta"]))

    def step(batch):
        losses = []
        for i in range(batch["tgt"].shape[0]):
            tgt = batch["tgt"][i].permute(0, 3, 1, 2)
            refs = batch["refs"][i].permute(0, 1, 4, 2, 3).flatten(1, 2)
            loss = (net["predict"](refs) - tgt).abs().mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return {"loss": torch.stack(losses)}

    return {"named": named, "optimizer": opt, "step": step}
'''

REFERENCE = '''
import torch
import torch.nn.functional as F

from benchmark.weights import init_weights


class Adam(torch.optim.Adam):
    def load(self, m, v, t):
        for p, a, b, s in zip(self.param_groups[0]["params"], m, v, t):
            self.state[p] = {"step": torch.tensor(float(s)), "exp_avg": a.to(p.device).clone(),
                             "exp_avg_sq": b.to(p.device).clone()}


class Step:
    def __init__(self, cfg, device, precision, seed=None):
        self.net = torch.nn.ModuleDict({"predict": torch.nn.Conv2d(6, 3, 3, padding=1)})
        self.net.to(device)
        if seed is not None:
            init_weights({"toy": self.net}, seed, device)
        self.named = [(f"toy.{n}", p) for n, p in self.net.named_parameters()]
        self.optimizer = Adam([p for _, p in self.named], lr=cfg["lr"],
                              betas=(cfg["momentum"], cfg["beta"]))

    def loss(self, batch, share=None):
        tgt, refs, k = batch
        conv = self.net["predict"]
        err = (F.conv2d(refs.flatten(1, 2), conv.weight, conv.bias, padding=1) - tgt).abs()
        if share is not None:
            err = err * share.view(-1, 1, 1, 1)
        return err.mean()
'''

FLOPS = '''
def flops_per_step(cfg):
    return 3.0 * 2 * cfg["batch_size"] * cfg["height"] * cfg["width"] * 3 * 6 * 9
'''

KERNELS = '''
GROUPS = (("toy_predict", ("toy_predict",)),)


def shapes(cfg, traffic):
    return {"frames": cfg["batch_size"], "height": cfg["height"], "width": cfg["width"]}


KERNEL_BYTES = {"toy_predict": lambda s: 4 * 9 * s["frames"] * s["height"] * s["width"]}
'''

RUN = '''
import json, torch
from benchmark import run, spec

cell = spec.resolve(spec.load_benchmark(), "toy.cell")
sound = run.measure(cell, 2 ** 31 + 5, 0.3, True, torch.device("cpu"))
program = spec.family("toy", "program")
build = program.build


def frozen(*args, **kwargs):
    built = build(*args, **kwargs)
    built["optimizer"].step = lambda closure=None: None
    return built


program.build = frozen
broken = run.measure(cell, 2 ** 31 + 5, 0.3, False, torch.device("cpu"))
print(json.dumps({"root": spec.ROOT, "sound": sound, "broken": broken}))
'''


def _files(root):
    out = {}
    for d, _, files in os.walk(root):
        if "__pycache__" in d or os.sep + "pool" in d:
            continue
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_a_family_of_its_own_runs_from_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    here = root / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__", "pool"))
    before = _files(HERE)
    family = here / "families" / "toy"
    family.mkdir()
    for name, text in (("program", PROGRAM), ("reference", REFERENCE), ("flops", FLOPS),
                       ("kernels", KERNELS)):
        (family / f"{name}.py").write_text(text)
    cfg = {"name": "toy_cfg", "family": "toy", "batch_size": 2, "sequence_length": 3,
           "height": tiny.H, "width": tiny.W, "fused_steps": 2, "lr": 1e-3, "momentum": 0.9,
           "beta": 0.999, "weight_decay": 0.0, "reduced": []}
    cfg["flops_per_step"] = 3.0 * 2 * 2 * tiny.H * tiny.W * 3 * 6 * 9
    (here / "configs" / "toy_cfg.json").write_text(json.dumps(cfg))
    pool = tiny.tiny_pool(str(tmp_path / "pool"))
    (here / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"name": "toy_mix", "data_path": "jpeg", "device_augment": False, "pool": pool,
         "scenes": 2, "frames_per_scene": 8, "workers": 2, "world_size": 1}))
    (here / "limits" / "toy.cell.json").write_text(json.dumps(
        {"reference": "fp32", "limits": {"loss1_rel": 1e-4, "update_rel": 1e-2,
                                         "replay_loss1_rel": 1e-4}}))
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "toy_cfg", "source": "https://example.org/toy",
                             "file": "benchmark/configs/toy_cfg.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy_cfg", "traffic": "toy_mix",
                               "chips": 1, "why": "a test"})
    for m in bench["per_layer"]:
        if m["name"] == "mfu_pct":
            m["workloads"].append("toy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _files(here)
    assert {k: after[k] for k in before} == before  # no harness file touched
    out = subprocess.run([sys.executable, "-c", RUN], cwd=str(root), capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), spec.ROOT])))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["root"] == str(root)
    assert got["sound"]["correct"] is True, got["sound"]["checked"]
    assert got["sound"]["metrics"]["mfu_pct"]["value"] > 0
    assert got["broken"]["correct"] is False
    assert got["broken"]["checked"]["update_rel"]["value"] > 0.5
