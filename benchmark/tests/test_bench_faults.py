"""A whole run on the CPU, the look for a card skipped, with the timed path broken underneath.

Each cell runs at a small size through the program's plain CPU path; a sound
run comes out correct, and each fault the cell can have makes ``correct``
false: a step that returns its state unchanged, half of the batch left out
(the mean taken over the rest in training), an answer altered where it is
produced. (No cell spans chips, so none can leave out an exchange between them.)
"""

import pytest
import torch

from benchmark import manifest
from benchmark.run import run_cell

BENCH = manifest.load()
SMALL = {"project": dict(batch=12, pool=2, in_flight=2, check_poses=12),
         "score": dict(batch=24, pool=2, in_flight=2, check_poses=24),
         "train": dict(noisy=48, manifold=40, pool=4, in_flight=2)}
PROJECT = ["lrelu-project-10k", "softplus-project-10k"]


def _run(cell: str):
    mix = manifest.traffic(manifest.cell(BENCH, cell)["traffic"])
    mix.update(SMALL[mix["kind"]])
    result, lines = run_cell(BENCH, cell, 2**31 + 77, 0.05, False, "cpu", traffic=mix)
    assert len(lines) == len(result["checks"])
    return result


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"


def _project_unchanged(monkeypatch):
    import posendf_torch.ops.fused_grad as fg

    real = fg.project_step_ref

    def step(q, w, **kw):
        d, _ = real(q, w, **kw)
        return d, q.clone()
    monkeypatch.setattr(fg, "project_step_ref", step)


def _project_half(monkeypatch):
    import posendf_torch.projection as pj

    real = pj.fused_project

    def project(poses, w, *, steps, **kw):
        h = poses.shape[0] // 2
        q, hist = real(poses[:h], w, steps=steps, **kw)
        return torch.cat([q, poses[h:]]), torch.cat([hist, hist.new_zeros(steps, h)], 1)
    monkeypatch.setattr(pj, "fused_project", project)


def _project_altered(monkeypatch):
    import posendf_torch.projection as pj

    real = pj.fused_project

    def project(poses, w, **kw):
        q, hist = real(poses, w, **kw)
        q[0, 0, 0] += 1e-3
        return q, hist
    monkeypatch.setattr(pj, "fused_project", project)


def _score_half(monkeypatch):
    import posendf_torch.field as fd

    real = fd.fused_posendf_forward

    def forward(quat, w):
        d = real(quat, w)
        d[quat.shape[0] // 2:] = 0.0
        return d
    monkeypatch.setattr(fd, "fused_posendf_forward", forward)


def _score_altered(monkeypatch):
    import posendf_torch.field as fd

    real = fd.fused_posendf_forward

    def forward(quat, w):
        d = real(quat, w)
        d[0] *= 1.01
        return d
    monkeypatch.setattr(fd, "fused_posendf_forward", forward)


def _train_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _train_half(monkeypatch):
    import posendf_torch.training.trainer as tr

    real = tr.fused_train_grads

    def grads(w, pose, dist, man, **kw):
        return real(w, pose[: len(pose) // 2], dist[: len(dist) // 2], man[: len(man) // 2], **kw)
    monkeypatch.setattr(tr, "fused_train_grads", grads)


def _train_altered(monkeypatch):
    import posendf_torch.training.trainer as tr

    real = tr.fused_train_grads

    def grads(*a, **kw):
        total, terms, g = real(*a, **kw)
        g["dfnet.b3"] = 2 * g["dfnet.b3"]
        return total, terms, g
    monkeypatch.setattr(tr, "fused_train_grads", grads)


FAULTS = ([(c, f) for c in PROJECT for f in (_project_unchanged, _project_half, _project_altered)]
          + [("lrelu-score-131k", f) for f in (_score_half, _score_altered)]
          + [("lrelu-train-20k", f) for f in (_train_unchanged, _train_half, _train_altered)])


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(cell)["correct"] is False
