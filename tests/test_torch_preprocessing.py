"""The port's CPU-side tools against the JAX package's on the same inputs:

- ``preprocessing/``: ``tests/test_preprocessing.py``'s cases, each run
  through both packages' functions: tracking, gap interpolation,
  Procrustes, the quaternion smoothing and the yaw / pitch / roll of the
  head pose (the JAX package rotates in float32, as the port does: atol
  1e-5 degrees on angles, 1e-6 on matrices), the affine crops, the Step-4
  filters, Step-5 resampling and the chunked pickle, Step-6 splits, the
  run log, the debug video's projection and its writer (cv2; skipped
  without it, as the JAX test does); and that each step module keeps its
  CLI flags;
- ``utils/common.py``: ``count_parameters`` equal to JAX's on the same tree
  (and of a module and its state dict), ``get_option_text`` text-equal,
  ``get_model_path``;
- ``utils/renderer.py`` against a mocked pyrender / trimesh, and
  ``utils/media.py``'s ffmpeg command lines.
"""

import argparse
import importlib
import pickle
import sys

import numpy as np
import jax
import pytest

MODULES = ("tracking", "transform", "runlog", "headpose", "step4_filter_dataset", "step5_resample_and_assemble",
           "step6_make_splits", "step1_detect_faces", "step2_head_pose", "step3_expression_code", "debug_video")


def _pair(module):
    return (importlib.import_module(f"msmd_tpu.preprocessing.{module}"),
            importlib.import_module(f"msmd_tpu_torch.preprocessing.{module}"))


def _rot_y(deg):
    r = np.deg2rad(deg)
    return np.array([[np.cos(r), 0, np.sin(r)], [0, 1, 0], [-np.sin(r), 0, np.cos(r)]])


def _same(a, b, atol=0.0):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, atol)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k], atol)
    else:
        np.testing.assert_allclose(np.asarray(b, float), np.asarray(a, float), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# tracking, transform
# ---------------------------------------------------------------------------

TRACK = lambda i: (0.9, (10 + i, 10, 20, 20))
DISTRACTOR = (0.95, (100, 100, 20, 20))
BOX_CASES = {
    "single": [[(0.9, (10, 10, 20, 20))] for _ in range(6)],
    "consistent": [[TRACK(i)] for i in range(5)] + [[DISTRACTOR, TRACK(5)], [TRACK(6)]],
    "low_iou": [[TRACK(0)], [TRACK(1)], [DISTRACTOR, TRACK(2)], [TRACK(3)]],
    "gap": [[(0.9, (0, 0, 10, 10))], [], [], [(0.9, (30, 0, 10, 10))]],
    "endpoints": [[], [(0.9, (5, 5, 10, 10))], []],
    "multiple_first": [[DISTRACTOR, TRACK(0)], [TRACK(1)], [TRACK(2)], [TRACK(3)]],
    "empty": [[], []],
}


@pytest.mark.parametrize("case", sorted(BOX_CASES))
def test_filter_boxes_matches_jax(case):
    j, t = _pair("tracking")
    (jb, jf), (tb, tf) = j.filter_boxes(BOX_CASES[case]), t.filter_boxes(BOX_CASES[case])
    assert jf == tf
    _same(jb, tb)


def test_iou_and_interpolate_gaps_match_jax():
    j, t = _pair("tracking")
    for a, b in (((0, 0, 10, 10), (0, 0, 10, 10)), ((0, 0, 10, 10), (20, 20, 5, 5)), ((0, 0, 10, 10), (5, 0, 10, 10))):
        assert t.calculate_iou(a, b) == j.calculate_iou(a, b)
    frames = [np.zeros((4, 3)), None, None, np.ones((4, 3)) * 3, None]
    (jo, jl), (to, tl) = j.interpolate_gaps(frames), t.interpolate_gaps(frames)
    assert jl == tl
    _same(jo, to)
    with pytest.raises(ValueError):
        t.interpolate_gaps([None, None])


def test_affine_transforms_match_jax():
    j, t = _pair("transform")
    for center, scale, rot, out in (([50.0, 80.0], 1.0, 0, (256, 256)), ([0.0, 0.0], 1.3, 90, (100, 100)),
                                    ([12.0, -3.0], [0.8, 1.1], 33, (64, 48))):
        for inv in (0, 1):
            jt = j.get_affine_transform(np.array(center), scale, rot, out, inv=inv)
            tt = t.get_affine_transform(np.array(center), scale, rot, out, inv=inv)
            np.testing.assert_array_equal(tt, jt)
        pts = np.array([[10.0, 0.0], [3.0, 7.0]])
        for inverse in (False, True):
            np.testing.assert_array_equal(t.transform_pixel_v2(pts, tt, inverse),
                                          j.transform_pixel_v2(pts, jt, inverse))


def test_crop_v2_matches_jax():
    cv2 = pytest.importorskip("cv2")  # noqa: F841
    j, t = _pair("transform")
    img = (np.random.RandomState(0).rand(80, 90, 3) * 255).astype(np.uint8)
    (jd, jt), (td, tt) = j.crop_v2(img, np.array([40.0, 45.0]), 0.3, (32, 32)), t.crop_v2(img, np.array([40.0, 45.0]),
                                                                                         0.3, (32, 32))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tt, jt)


# ---------------------------------------------------------------------------
# head pose
# ---------------------------------------------------------------------------

def test_procrustes_and_rotate_to_neutral_match_jax():
    j, t = _pair("headpose")
    rng = np.random.RandomState(0)
    X = rng.randn(3, 20)
    Y = 1.7 * _rot_y(25.0) @ X + np.array([[0.3], [-0.2], [0.5]])
    _same(j.procrustes_analysis(X, Y), t.procrustes_analysis(X, Y))
    neutral = np.random.RandomState(1).randn(30, 3)
    frames = np.stack([(_rot_y(10 * i) @ neutral.T).T for i in range(5)])
    _same(j.rotate_to_neutral(neutral, frames, list(range(12)), return_rotation=True),
          t.rotate_to_neutral(neutral, frames, list(range(12)), return_rotation=True))


def test_smoothing_and_yaw_pitch_roll_match_jax():
    j, t = _pair("headpose")
    mats = [_rot_y(3 * i + np.random.RandomState(i).randn() * 2) @ _rot_y(0) for i in range(20)]
    js, ts = j.smooth_rotation_matrices(mats, 7, 3), t.smooth_rotation_matrices(mats, 7, 3)
    assert len(ts) == 20 and ts[0].dtype == js[0].dtype == np.float32
    _same(js, ts, atol=1e-6)
    for R in ts:
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    flip = [np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], float)]
    _same(j.rotations_to_yaw_pitch_roll(flip + mats), t.rotations_to_yaw_pitch_roll(flip + mats), atol=1e-9)
    assert t.side_profile_fraction(np.array([0, 10, 60, -70, 5])) == j.side_profile_fraction(
        np.array([0, 10, 60, -70, 5]))


def test_yaw_pitch_roll_without_scipy_matches_jax(monkeypatch):
    """The fallback through the rotations (f32 in both packages) when
    scipy's Rotation cannot be imported."""
    j, t = _pair("headpose")
    monkeypatch.setitem(sys.modules, "scipy.spatial.transform", None)
    mats = [_rot_y(7 * i) for i in range(6)]
    _same(j.rotations_to_yaw_pitch_roll(mats), t.rotations_to_yaw_pitch_roll(mats), atol=1e-5)


def test_head_pose_track_matches_jax():
    j, t = _pair("headpose")
    rng = np.random.RandomState(3)
    canonical = rng.randn(478, 3)
    frames = np.stack([(_rot_y(4 * i) @ canonical.T).T + rng.randn(478, 3) * 1e-3 for i in range(12)])
    jy = j.head_pose_track_from_landmarks(frames, canonical, list(range(40)))
    ty = t.head_pose_track_from_landmarks(frames, canonical, list(range(40)))
    assert ty.shape == (12, 3) and abs(ty[-1, 0] - ty[0, 0]) > 20
    np.testing.assert_allclose(ty, jy, atol=1e-5)


# ---------------------------------------------------------------------------
# steps 4-6, run log, debug video
# ---------------------------------------------------------------------------

def test_step4_filters_match_jax(tmp_path):
    j, t = _pair("step4_filter_dataset")
    assert t.filter_has_audio(["a", "b"], {"a"}) == j.filter_has_audio(["a", "b"], {"a"}) == ["a"]
    ann = {"a": [("talk", 0, 1)], "b": [("sleep", 0, 1)], "c": [("sing", 0, 1)]}
    assert t.filter_speech_annotations(["a", "b", "c", "d"], ann) == j.filter_speech_annotations(["a", "b", "c", "d"],
                                                                                                   ann)
    for v, pose in [("a", np.zeros((10, 3))), ("c", np.concatenate([np.zeros((4, 3)), np.full((6, 3), 80.0)]))]:
        with open(tmp_path / f"{v}.pkl", "wb") as f:
            pickle.dump(pose, f)
    for logs in ([{"video_name": "a", "error_too_many_missing_frames": False}],
                 [{"video_name": "c", "error_too_many_missing_frames": True}]):
        assert t.filter_valid_tracking(["a", "b", "c"], tmp_path, logs) == j.filter_valid_tracking(
            ["a", "b", "c"], tmp_path, logs)
    assert t.filter_side_profiles(["a", "c"], tmp_path) == j.filter_side_profiles(["a", "c"], tmp_path) == ["a"]


def test_step5_and_step6_match_jax(tmp_path):
    j5, t5 = _pair("step5_resample_and_assemble")
    j6, t6 = _pair("step6_make_splits")
    rs = np.random.RandomState(0)
    head, exp, audio = rs.randn(60, 3), rs.randn(60, 64), rs.randn(44100 * 2, 2)
    _same(j5.resample_clip(head, exp, audio, 24.0, 44100, 30, 16000), t5.resample_clip(head, exp, audio, 24.0, 44100,
                                                                                        30, 16000))
    data = {f"v{i}": {"x": np.arange(i)} for i in range(25)}
    t5.save_chunked_pickle(data, tmp_path / "t.pkl", chunk_size=10)
    j5.save_chunked_pickle(data, tmp_path / "j.pkl", chunk_size=10)
    assert (tmp_path / "t.pkl").read_bytes() == (tmp_path / "j.pkl").read_bytes()
    from msmd_tpu_torch.data.pickle_dataset import load_chunked_pickle

    assert set(load_chunked_pickle(tmp_path / "t.pkl")) == set(data)
    keys = list(data)
    assert t6.make_splits(keys, seed=42) == j6.make_splits(keys, seed=42)
    assert t6.make_splits(keys, seed=3, train_frac=0.6) == j6.make_splits(keys, seed=3, train_frac=0.6)
    splits = t6.make_splits(keys)
    t6.write_split_files(tmp_path, "t", splits)
    j6.write_split_files(tmp_path, "j", splits)
    for s in splits:
        assert (tmp_path / f"t_keys_{s}.txt").read_text() == (tmp_path / f"j_keys_{s}.txt").read_text()
    with pytest.raises(AssertionError, match="overlap"):
        t6.assert_disjoint({"train": ["a"], "test": ["a"]})


def test_runlog_matches_jax(tmp_path):
    j, t = _pair("runlog")
    with open(tmp_path / "video_split_0.pkl", "wb") as f:
        pickle.dump([["vid1"], "vid2"], f)
    assert t.load_shard(tmp_path, "0") == j.load_shard(tmp_path, "0") == ["vid1", "vid2"]
    for mod, name in ((t, "t"), (j, "j")):
        log = mod.RunLog(tmp_path / name, "0")
        log.append({"video_name": "vid1", "ok": True})
        (tmp_path / "vid1.out").write_text("done")
        log2 = mod.RunLog(tmp_path / name, "0")
        assert log2.should_skip("vid1", tmp_path / "vid1.out")
        assert not log2.should_skip("vid2", tmp_path / "vid2.out")
    assert (tmp_path / "t" / "runlog_0.json").read_text() == (tmp_path / "j" / "runlog_0.json").read_text()


def test_debug_video_projection_matches_jax():
    j, t = _pair("debug_video")
    ypr = np.array([[20.0, -10.0, 5.0], [-35.0, 15.0, -8.0], [90.0, 0.0, 0.0]])
    jR, tR = j.ypr_to_rotation_matrices(ypr), t.ypr_to_rotation_matrices(ypr)
    np.testing.assert_array_equal(tR, jR)
    for R in [np.eye(3)] + list(tR):
        box = (100, 50, 40, 20)
        np.testing.assert_array_equal(t.project_pose_axes(R, box), j.project_pose_axes(R, box))


def test_debug_video_writer_matches_jax(tmp_path):
    cv = pytest.importorskip("cv2")
    j, t = _pair("debug_video")
    src = str(tmp_path / "src.mp4")
    w = cv.VideoWriter(src, cv.VideoWriter_fourcc(*"mp4v"), 25.0, (64, 64))
    for _ in range(4):
        w.write(np.zeros((64, 64, 3), np.uint8))
    w.release()
    Rs, boxes = [np.eye(3), None, np.eye(3), np.eye(3)], [(10, 10, 20, 20)] * 4
    frames = {}
    for mod, name in ((t, "t"), (j, "j")):
        out = str(tmp_path / f"{name}.mp4")
        assert mod.write_debug_video(src, out, Rs, boxes, axis_length=15.0) == 4
        cap = cv.VideoCapture(out)
        frames[name] = [cap.read()[1] for _ in range(4)]
        cap.release()
    for a, b in zip(frames["t"], frames["j"]):
        np.testing.assert_array_equal(a, b)
    assert frames["t"][0].sum() > frames["t"][1].sum()


def _flags(monkeypatch, mod):
    """The options ``main`` declares (names, type, default, required,
    action), read by running it with a parser that records them and stops
    at ``parse_args``."""
    seen = []

    class Stop(Exception):
        pass

    real_add = argparse.ArgumentParser.add_argument

    def add_argument(self, *names, **kw):
        seen.append((names, kw.get("type"), kw.get("default"), kw.get("required"), kw.get("action")))
        return real_add(self, *names, **kw)

    def parse_args(self, *a, **k):
        raise Stop

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "add_argument", add_argument)
        m.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(Stop):
            mod.main()
    return seen


@pytest.mark.parametrize("module", [m for m in MODULES if m.startswith("step")])
def test_step_clis_keep_their_flags(monkeypatch, module):
    j, t = _pair(module)
    flags = _flags(monkeypatch, t)
    assert flags == _flags(monkeypatch, j) and len(flags) >= 3


def test_step3_placeholder_and_box_smoothing_match_jax():
    j, t = _pair("step3_expression_code")
    boxes = np.random.RandomState(0).rand(15, 4) * 50
    np.testing.assert_array_equal(t.smooth_boxes(boxes), j.smooth_boxes(boxes))
    np.testing.assert_array_equal(t.smooth_boxes(boxes[:2]), j.smooth_boxes(boxes[:2]))
    with pytest.raises(NotImplementedError):
        t.ExpressionCodeExtractor()(np.zeros((1, 3, 256, 256), np.float32))
    s1j, s1t = _pair("step2_head_pose")
    lm = np.random.RandomState(1).rand(30, 2)
    assert s1t.compute_bounding_box(lm, 640, 480) == s1j.compute_bounding_box(lm, 640, 480)
    assert s1t.scaled_crop_box((10, 20, 50, 60), (480, 640)) == s1j.scaled_crop_box((10, 20, 50, 60), (480, 640))
    mapping = {"nose": {"dorsum": [1, 2], "tipLower": [3]}, "additional_anchors": [4, 5]}
    assert s1t.static_landmark_indices(mapping) == s1j.static_landmark_indices(mapping) == [1, 2, 3, 4, 5]


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_count_parameters_and_option_text_match_jax(tmp_path):
    from msmd_tpu.config import MSMDConfig as JCfg
    from msmd_tpu.models.style_encoder import StyleEncoderVAE2 as JVAE2
    from msmd_tpu.utils import common as jc
    from msmd_tpu_torch.config import MSMDConfig
    from msmd_tpu_torch.interop import load_flax_params
    from msmd_tpu_torch.models.style_encoder import StyleEncoderVAE2
    from msmd_tpu_torch.utils import common as tc

    variables = JVAE2(d_style=16, conv_feature_dim=64).init(
        {"params": jax.random.PRNGKey(0), "style": jax.random.PRNGKey(1)}, np.zeros((1, 8, 67), np.float32))
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    module = load_flax_params(StyleEncoderVAE2(d_style=16, conv_feature_dim=64), tree)
    want = jc.count_parameters(variables["params"])
    assert tc.count_parameters(tree) == tc.count_parameters(module) == want
    assert tc.count_parameters(module.state_dict()) == want
    kw = dict(d_style=16, feature_dim=32, n_heads=4, lr=3e-4, style_enc_model_style="vae2")
    assert tc.get_option_text(MSMDConfig(**kw)) == jc.get_option_text(JCfg(**kw))
    assert "[default:" in tc.get_option_text(MSMDConfig(**kw))
    (tmp_path / "exp_2024" / "checkpoints").mkdir(parents=True)
    assert tc.get_model_path("exp", 12, exp_root=tmp_path) == jc.get_model_path("exp", 12, exp_root=tmp_path)
    assert tc.get_model_path("exp", 12, exp_root=tmp_path)[0].name == "iter_0000012.pt"


def test_media_commands_match_jax(monkeypatch, tmp_path):
    from msmd_tpu.utils import media as jm
    from msmd_tpu_torch.utils import media as tm

    runs = {}
    for mod, name in ((tm, "t"), (jm, "j")):
        runs[name] = []
        monkeypatch.setattr(mod.subprocess, "run",
                            lambda cmd, _r=runs[name]: _r.append(cmd) or type("R", (), {"returncode": 0})())
        mod.combine_video_and_audio("v.mp4", "a.wav", "o.mp4")
        mod.combine_frames_and_audio("%06d.jpg", "a.wav", 25, "o.mp4", quality=20)
        mod.convert_video("v.mp4", "o.mp4")
        mod.reencode_audio("a.m4a", "a.wav")
        mod.extract_frames("v.mp4", tmp_path / name)
    assert [c[:-1] for c in runs["t"][:4]] == [c[:-1] for c in runs["j"][:4]]
    assert runs["t"][0][0] == "ffmpeg" and len(runs["t"]) == 5
    monkeypatch.setattr(tm.subprocess, "run", lambda cmd: type("R", (), {"returncode": 1})())
    with pytest.raises(RuntimeError, match="ffmpeg failed"):
        tm.convert_video("v.mp4", "o.mp4")


def test_mesh_renderer_matches_jax_with_mocked_gl(monkeypatch):
    from test_renderer_flametex import _fake_pyrender, _fake_trimesh

    from msmd_tpu.utils import renderer as jr
    from msmd_tpu_torch.utils import renderer as tr

    size = (32, 24)
    monkeypatch.setitem(sys.modules, "pyrender", _fake_pyrender(size))
    monkeypatch.setitem(sys.modules, "trimesh", _fake_trimesh())
    t, j = tr.MeshRenderer(size), jr.MeshRenderer(size)
    assert len(t.light_nodes) == 5
    _same([n.pose for n in j.light_nodes], [n.pose for n in t.light_nodes])
    verts = np.random.RandomState(0).randn(10, 3).astype(np.float32) * 0.01
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    n_before = len(t.scene.nodes)
    color, depth = t.render_mesh(verts, faces, t_center=np.zeros(3), rot=np.array([0.1, 0.2, 0.3]))
    assert color.shape == (24, 32, 3) and depth.shape == (24, 32) and len(t.scene.nodes) == n_before
    for seed in range(3):
        rot = np.random.RandomState(seed).randn(3)
        np.testing.assert_array_equal(tr._rodrigues(rot), jr._rodrigues(rot))
    pose = np.eye(4)
    pose[:3, 3] = [0, 0, 1]
    _same(jr.MeshRenderer._get_light_poses(np.pi / 6, pose), tr.MeshRenderer._get_light_poses(np.pi / 6, pose))


def test_tools_import_without_jax_or_gl():
    """Every tool module imports with JAX, the JAX package and the optional
    GL / video stacks blocked."""
    import subprocess

    from test_torch_common import REPO

    mods = [f"msmd_tpu_torch.preprocessing.{m}" for m in MODULES] + [
        "msmd_tpu_torch.utils.common", "msmd_tpu_torch.utils.media", "msmd_tpu_torch.utils.renderer"]
    code = ("import sys\n"
            "for m in ('jax', 'msmd_tpu', 'cv2', 'mediapipe', 'pyrender', 'trimesh', 'lmdb', 'librosa'):\n"
            "    sys.modules[m] = None\n"
            f"import importlib\nfor m in {mods!r}:\n    importlib.import_module(m)\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
