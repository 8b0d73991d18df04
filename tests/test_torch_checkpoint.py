"""Port's checkpoints vs the reference's (CPU): one file format both
ways, the reference's session checkpoint cases on the port session, and
mid-trace cross-restores between a JAX ``serve="host"`` session and a
port ``device="cpu"`` session in both directions.

Mirrors ``tests/test_session.py`` (checkpoint round trip, restore needs
allocated lanes) and ``tests/test_churn.py`` (lane map and active mask,
mid-run restore bit-identical). Everything is held exactly: a checkpoint
carries bytes, and the control planes are bit-identical twins."""
import json
from dataclasses import dataclass

import jax
import msgpack
import numpy as np
import pytest
import torch
import zstandard

import repro.core as jcore
import repro_torch.core as tcore
from repro.train import checkpoint as jckpt
from repro_torch.train import checkpoint as tckpt


def _payload(path, step):
    raw = (path / f"{step:010d}.ckpt").read_bytes()
    return msgpack.unpackb(zstandard.ZstdDecompressor().decompress(raw),
                           raw=False)


def _tree(rng):
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "blocks": ({"a": rng.integers(-5, 5, (2,)).astype(np.int32)},
                       {"a": np.array(True)}),
            "flag": rng.random((5,)) < 0.5,
            "empty": np.zeros((2, 0), np.float32)}


def test_both_packages_write_the_same_bytes(tmp_path, rng):
    tree = _tree(rng)
    meta = {"kind": "x", "ids": [["cam-a", 0], [7, 1]]}
    jckpt.save(tmp_path / "j", 5, jax.tree_util.tree_map(np.asarray, tree),
               metadata=meta)
    ttree = {"w": torch.from_numpy(tree["w"]), "blocks": tree["blocks"],
             "flag": torch.from_numpy(tree["flag"]),
             "empty": torch.zeros((2, 0))}
    tckpt.save(tmp_path / "t", 5, ttree, metadata=meta)
    a, b = _payload(tmp_path / "j", 5), _payload(tmp_path / "t", 5)
    assert list(a["arrays"]) == ["blocks/0/a", "blocks/1/a", "empty",
                                 "flag", "w"]
    assert a == b
    assert ((tmp_path / "j" / "0000000005.ckpt").read_bytes()
            == (tmp_path / "t" / "0000000005.ckpt").read_bytes())


def test_reference_file_restores_in_the_port(tmp_path, rng):
    tree = _tree(rng)
    jckpt.save(tmp_path, 3, tree, metadata={"m": 1})
    out, step, meta = tckpt.restore(tmp_path, tree, device="cpu")
    assert (step, meta) == (3, {"m": 1})
    flat_in = jax.tree_util.tree_leaves(tree)
    flat_out = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), out))
    assert len(flat_in) == len(flat_out)
    for x, y in zip(flat_in, flat_out):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_port_file_restores_in_the_reference(tmp_path, rng):
    tree = _tree(rng)
    tckpt.save(tmp_path, 4, jax.tree_util.tree_map(torch.from_numpy, tree))
    tmpl = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree)
    out, step, _ = jckpt.restore(tmp_path, tmpl)
    assert step == 4
    for x, y in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(out)):
        assert x.dtype == np.asarray(y).dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, np.asarray(y))


def test_restore_errors_latest_step_prune_and_async(tmp_path, rng):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "none", tree, device="cpu")
    for s in (1, 2, 3, 4):
        th = tckpt.save(tmp_path, s, {"a": torch.full((2, 3), float(s))},
                        async_=True)
        th.join()
    assert tckpt.latest_step(tmp_path) == 4
    assert not list(tmp_path.glob(".tmp.*"))
    tckpt.prune(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.glob("*.ckpt")) == [
        "0000000003.ckpt", "0000000004.ckpt"]
    out, step, _ = tckpt.restore(tmp_path, tree, device="cpu")
    assert step == 4 and torch.equal(out["a"], torch.full((2, 3), 4.0))
    with pytest.raises(KeyError):
        tckpt.restore(tmp_path, {"b": tree["a"]}, device="cpu")
    with pytest.raises(ValueError):
        tckpt.restore(tmp_path, {"a": np.zeros((3, 2), np.float32)},
                      device="cpu")


def test_async_save_copies_before_the_writer_starts(tmp_path):
    x = torch.zeros((1000,))
    th = tckpt.save(tmp_path, 1, {"x": x}, async_=True)
    x += 1.0
    th.join()
    out, _, _ = tckpt.restore(tmp_path, {"x": x}, device="cpu")
    assert float(out["x"].abs().sum()) == 0.0


# -- the reference's session cases on the port session ----------------------

def test_session_checkpoint_roundtrip(tmp_path, rng):
    q = tcore.Query.any_of("red", "yellow", latency_bound=1.0, fps=10.0)
    sess = tcore.open_session(q, num_cameras=2, frame_shape=(12, 20),
                              device="cpu")
    frames = rng.uniform(0, 255, (2, 6, 12, 20, 3)).astype(np.float32)
    res = sess.ingest(frames)
    sess.fit(res.pf.reshape(-1, 2, 8, 8), rng.random(12) < 0.5)
    res2 = sess.ingest(frames)
    sess.report_backend_latency(0.15)
    sess.report_ingress_fps(24.0)
    sess.tick()
    sess.admit(res2.utility)
    sess.checkpoint(tmp_path, step=3)

    fresh = tcore.open_session(q, num_cameras=2, frame_shape=(12, 20),
                               device="cpu")
    step, meta = fresh.restore(tmp_path)
    assert step == 3
    assert meta["colors"] == ["red", "yellow"] and meta["num_cameras"] == 2
    for k, v in sess.state.as_dict().items():
        np.testing.assert_array_equal(v, fresh.state.as_dict()[k],
                                      err_msg=k)
    a, b = sess.ingest(frames), fresh.ingest(frames)
    np.testing.assert_array_equal(a.pf, b.pf)
    np.testing.assert_array_equal(a.utility, b.utility)


def test_session_restore_requires_allocated_lanes(tmp_path, rng):
    q = tcore.Query.single("red")
    sess = tcore.open_session(q, num_cameras=1, frame_shape=(8, 8),
                              device="cpu")
    sess.ingest(rng.uniform(0, 255, (1, 2, 8, 8, 3)).astype(np.float32))
    sess.checkpoint(tmp_path, step=1)
    other = tcore.open_session(q, num_cameras=1, device="cpu")
    with pytest.raises(ValueError):
        other.restore(tmp_path)


@dataclass(frozen=True)
class Rec:
    cam_id: object
    frame_idx: int


def _churn_session(core, C=2, **kw):
    opts = dict(device="cpu") if core is tcore else dict(serve="host")
    return core.open_session(core.Query.single(core.RED, latency_bound=1.0,
                                               fps=10.0),
                             num_cameras=C, **opts, **kw)


def _feed(sess, cam_ids, utils):
    return [sess.offer(Rec(cam_ids[i % len(cam_ids)], i), float(u))
            for i, u in enumerate(utils)]


def test_checkpoint_roundtrips_lane_map_and_active_mask(tmp_path):
    sess = _churn_session(tcore, C=3)
    _feed(sess, ["x", "y", "z"], np.random.default_rng(5).random(30))
    sess.detach_camera("y")
    sess.set_rate_floor(0.25)
    sess.checkpoint(tmp_path / "ckpt", step=4)

    other = _churn_session(tcore, C=3)
    step, meta = other.restore(tmp_path / "ckpt")
    assert step == 4
    assert meta["lane_map"] == [["x", 0], ["z", 2]]
    assert other.num_active == 2
    assert not bool(other.state.active[1])
    assert other.rate_floor == 0.25
    assert other.lane("x") == 0 and other.lane("z") == 2
    assert other.attach_camera("w") == 1
    assert other.num_active == 3


def _snap(sess):
    t = sess.tick()
    return json.dumps({k: t[k] for k in ("target_drop_rate", "threshold",
                                         "queue_size", "per_camera")},
                      sort_keys=True)


def test_midrun_checkpoint_restore_is_bit_identical(tmp_path):
    rng = np.random.default_rng(11)
    seg1, seg2 = rng.random(40), rng.random(50)

    def segment2(sess):
        sess.report_backend_latency(0.04)
        sess.report_ingress_fps(25.0)
        return _feed(sess, ["a", "b"], seg2), _snap(sess)

    live = _churn_session(tcore)
    _feed(live, ["a", "b"], seg1)
    live.report_backend_latency(0.06)
    live.report_ingress_fps(30.0)
    live.tick()
    live.checkpoint(tmp_path / "mid", step=1)
    out_live = segment2(live)

    resumed = _churn_session(tcore)
    resumed.restore(tmp_path / "mid")
    assert segment2(resumed) == out_live
    for k, v in live.state.as_dict().items():
        np.testing.assert_array_equal(v, resumed.state.as_dict()[k],
                                      err_msg=k)


# -- cross-restore between the packages -------------------------------------

C, T = 4, 5
IDS = ["north", "south", 7]


def _pre(sess, rng):
    """A mid-trace state: string and int camera ids on three of four
    lanes, a detached lane, a rate floor, queued frames, ticks."""
    for i in range(6):
        ids = IDS if i <= 2 else [x for x in IDS if x != "south"]
        items = [Rec(ids[j % len(ids)], 10 * i + j) for j in range(7)]
        sess.offer_batch(items, rng.uniform(0, 1, 7).astype(np.float32))
        sess.report_backend_latency(float(rng.uniform(0.02, 0.2)),
                                    cam=int(rng.integers(C)) if i % 2
                                    else None)
        sess.report_ingress_fps(float(rng.uniform(5, 20)),
                                cam=1 if i == 3 else None)
        sess.step(utilities=rng.uniform(0, 1, (C, T)).astype(np.float32),
                  tick=i % 2 == 0)
        if i == 2:
            sess.detach_camera("south")
        if i == 4:
            sess.set_rate_floor(0.3)
        sess.next_frames(2)


def _post(sess, rng, log):
    """What follows the checkpoint: a new camera claims the freed lane,
    then utility steps, coalesced offers and pops."""
    log.append(("attach", sess.attach_camera("west")))
    for i in range(6):
        items = [Rec(["north", "west", 7][j % 3], 100 + 10 * i + j)
                 for j in range(6)]
        log.append(("offer_batch", sess.offer_batch(
            items, rng.uniform(0, 1, 6).astype(np.float32))))
        sess.report_backend_latency(float(rng.uniform(0.02, 0.2)))
        r = sess.step(utilities=rng.uniform(0, 1, (C, T)).astype(np.float32),
                      tick=i % 3 != 1)
        log.append(("step", r.decisions.tolist(), r.pushed_seq.tolist(),
                    [e.tolist() for e in r.evicted],
                    None if r.target_drop_rate is None
                    else r.target_drop_rate.tolist()))
        log.append(("depths", sess.queue_depths().tolist(),
                    sess.num_active, np.float32(sess.rate_floor)))
        log.append(("state", {k: v.tolist() for k, v in
                              sess.state.as_dict().items()}))
        log.append(("pop", [tuple(x) if isinstance(x, tuple) else x
                            for x in sess.next_frames(3)]))
    log.append(("lanes", sorted(map(str, sess._lane_of.items()))))


def _cross(tmp_path, src, dst):
    rng = np.random.default_rng(20)
    live = _churn_session(src, C)
    _pre(live, rng)
    live.checkpoint(tmp_path / "x", step=9)
    a, b, c = [], [], []
    back = _churn_session(src, C)
    back.restore(tmp_path / "x")
    other = _churn_session(dst, C)
    step, meta = other.restore(tmp_path / "x")
    assert step == 9 and meta["lane_map"] == [["north", 0], [7, 2]]
    assert other.num_active == 3 and other.rate_floor == np.float32(0.3)
    assert not bool(np.asarray(other.state.active)[1])
    for sess, log in ((live, a), (back, b), (other, c)):
        _post(sess, np.random.default_rng(22), log)
    # the live session keeps its pre-checkpoint payloads; a restored one
    # pops their (cam, seq) pairs instead, the same in both packages
    assert c == b
    strip = [e for e in a if e[0] != "pop"]
    assert [e for e in c if e[0] != "pop"] == strip


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    _cross(tmp_path, jcore, tcore)


def test_port_checkpoint_continues_in_jax(tmp_path):
    _cross(tmp_path, tcore, jcore)


def test_session_files_match_key_for_key(tmp_path):
    """After the same trace, a JAX host session and a port session write
    the same keys with the same dtypes, shapes and bytes."""
    files = {}
    for name, core in (("j", jcore), ("t", tcore)):
        sess = _churn_session(core, C)
        _pre(sess, np.random.default_rng(20))
        sess.checkpoint(tmp_path / name, step=2)
        files[name] = _payload(tmp_path / name, 2)
    j, t = files["j"], files["t"]
    assert list(t["arrays"]) == list(j["arrays"])
    for k in j["arrays"]:
        assert t["arrays"][k]["dtype"] == j["arrays"][k]["dtype"], k
        assert t["arrays"][k]["shape"] == j["arrays"][k]["shape"], k
        assert t["arrays"][k]["data"] == j["arrays"][k]["data"], k
    assert t["__meta__"] == j["__meta__"]
