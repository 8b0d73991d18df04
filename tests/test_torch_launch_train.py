"""The port's training launcher (``python -m repro_torch.launch.train``)
end to end on the CPU at smollm's smoke config: a run with an injected
fault restarts once and ends on its final checkpoint, a second run
resumes from it, the loss falls, and without a card every entry point
raises instead of running on the CPU; a mesh asked for in one process is
the one-device program. Counts and checkpoint steps are exact."""
import pytest
import torch

from repro_torch.launch import train as launch
from repro_torch.sharding.api import tree_leaves
from repro_torch.train import checkpoint as ckpt

ARGS = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--batch",
        "4", "--seq", "32", "--ckpt-every", "5", "--lr", "3e-3"]


def test_fault_restart_final_checkpoint_and_resume(tmp_path, capsys):
    d = str(tmp_path / "ck")
    seen = []
    rep = launch.main(ARGS + ["--steps", "20", "--inject-fault-at", "12",
                              "--ckpt-dir", d],
                      metrics_cb=lambda i, m, dt: seen.append((i, m)))
    assert rep.restarts == 1
    assert rep.steps_run == 20 + 2           # steps 10 and 11 replayed
    assert [i for i, _ in seen] == list(range(12)) + list(range(10, 20))
    assert ckpt.latest_step(d) == 20
    out = capsys.readouterr().out
    assert "arch=smollm-smoke" in out and "device=cpu" in out
    assert "done: steps=22 restarts=1" in out
    # a replayed step sees the same batch from the same state
    assert seen[10][1] == seen[12][1] and seen[11][1] == seen[13][1]
    loss = [m["loss"] for _, m in seen]
    assert sum(loss[-5:]) < sum(loss[:5])
    # the checkpoint holds the launcher's state at step 20
    cfg, params, opt_state, _, _ = launch.build("smollm-135m", True, 4, 32,
                                                20, device="cpu")
    state, step, meta = ckpt.restore(d, {"params": params,
                                         "opt_state": opt_state},
                                     device="cpu")
    assert step == 20 and int(state["opt_state"]["step"]) == 20
    assert meta["metrics"]["loss"] == rep.last_metrics["loss"]
    rep2 = launch.main(ARGS + ["--steps", "25", "--ckpt-dir", d])
    assert rep2.steps_run == 5 and rep2.restarts == 0
    assert ckpt.latest_step(d) == 25


def test_build_is_seeded():
    a = launch.build("smollm-135m", True, 4, 32, 10, device="cpu")
    b = launch.build("smollm-135m", True, 4, 32, 10, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[1]),
                                                 tree_leaves(b[1])))
    assert int(a[2]["step"]) == 0 and a[4] == torch.device("cpu")


def test_refusals_without_a_card_or_with_a_mesh(tmp_path):
    # a mesh no longer refuses: in one process it clamps to (1, 1), the
    # one-device program (tests/test_torch_mesh.py, test_torch_distributed.py)
    plain = launch.build("smollm-135m", True, 4, 32, 10, device="cpu")
    try:
        for axes in ({"data_axis": 2}, {"model_axis": 2}):
            meshed = launch.build("smollm-135m", True, 4, 32, 10,
                                  device="cpu", **axes)
            assert all(type(y) is torch.Tensor and torch.equal(x, y)
                       for x, y in zip(tree_leaves(plain[1]),
                                       tree_leaves(meshed[1])))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if not torch.cuda.is_available():      # the default is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.main(["--smoke", "--steps", "1",
                         "--ckpt-dir", str(tmp_path / "ck")])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.build("smollm-135m", True, 4, 32, 10)
        assert not (tmp_path / "ck").exists()
