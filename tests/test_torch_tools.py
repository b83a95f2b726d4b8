"""The port's tools (unet_tpu_torch.tools, data/labelme.py, `cli tools`)
against the JAX package's (tests/test_tools.py,
test_events_data.py::test_labelme_conversion): the same seeded inputs and
files through both, with the same return values, the same JSON and arrays
bit for bit, and the same files written, byte for byte."""
import json
import os
import shutil
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
import unet_tpu.tools as J
import unet_tpu_torch.tools as P
from unet_tpu.cli.main import main as jmain
from unet_tpu.data import labelme as jlabelme
from unet_tpu.tools import interactive as JI
from unet_tpu_torch.cli.main import main as pmain
from unet_tpu_torch.data import labelme as plabelme
from unet_tpu_torch.tools import interactive as PI
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _files(root) -> dict:
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _same_tree(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    assert fa, f"nothing written under {a}"
    for k in fa:
        assert fa[k] == fb[k], k


def _both(tmp_path, fn):
    """fn(package, out_dir) for the JAX package ('j') and the port ('p');
    returns both results after holding their output trees equal."""
    rj, rp = fn(J, tmp_path / "j"), fn(P, tmp_path / "p")
    _same_tree(tmp_path / "j", tmp_path / "p")
    return rj, rp


@pytest.fixture
def video(tmp_path, rng):
    p = str(tmp_path / "v.mp4")
    wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 64))
    base = (rng.random((64, 96, 3)) * 255).astype(np.uint8)
    for i in range(20):
        f = base.copy()
        if i >= 10:
            f = 255 - f
        f[:, 40 + (i % 3):50 + (i % 3)] = 200
        wr.write(f)
    wr.release()
    return p


def test_extract_frames_dedup_ahash(video, tmp_path, rng):
    rj, rp = _both(tmp_path, lambda T, d: T.extract_frames(video, str(d), fps=10.0, dedup=0.95))
    assert rj == rp and 2 <= rp < 20
    rj, rp = _both(tmp_path / "roi", lambda T, d: T.extract_frames(
        video, str(d), fps=5.0, roi=(10, 4, 60, 50), quality_gate=True, blur_th=5.0))
    assert rj == rp
    img = (rng.random((64, 96, 3)) * 255).astype(np.uint8)
    assert np.array_equal(J.ahash(img), P.ahash(img))
    assert P.hash_similarity(P.ahash(img), P.ahash(255 - img)) == \
        J.hash_similarity(J.ahash(img), J.ahash(255 - img))


def test_audit_labelme(tmp_path):
    docs = {
        "good": [{"label": "cable", "points": [[5, 5], [30, 5], [30, 40], [5, 40]]}],
        "oob": [{"label": "tape", "points": [[0, 0], [500, 0], [500, 40]]}],
        "selfx": [{"label": "cable", "points": [[0, 0], [20, 20], [20, 0], [0, 20]]}],
        "tiny": [{"label": "burr_defect", "points": [[1, 1], [4, 1], [4, 4], [1, 4]]}],
        "empty": [{"label": "bulge_defect", "points": [[5, 5], [9, 5], [9, 9]]}],
        "odd": [{"label": "mystery", "points": [[1, 1], [9, 1], [9, 9]]},
                {"label": "thin_defect", "points": [[1, 1], [2, 1]]}]}
    for name, shapes in docs.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(
            {"imageHeight": 50, "imageWidth": 60, "shapes": shapes}))
    (tmp_path / "broken.json").write_text("{not json")
    want, got = J.audit_labelme_dir(str(tmp_path)), P.audit_labelme_dir(str(tmp_path))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["total"] == 7 and got["class_distribution"]["cable"] == 1


def test_diagnose_distribution_remap(tmp_path):
    mdir = tmp_path / "masks"
    mdir.mkdir()
    m = np.zeros((32, 32), np.uint8)
    m[:, 10:20] = 1
    m[5:10, 5:25] = 6
    cv2.imwrite(str(mdir / "a.png"), m)
    cv2.imwrite(str(mdir / "b.png"), np.zeros((32, 32), np.uint8))
    for kw in (dict(num_classes=3, resized_hw=(16, 16)), dict(num_classes=7)):
        assert P.diagnose_mask(m, **kw) == J.diagnose_mask(m, **kw)
    assert P.class_pixel_distribution(str(mdir), 7) == J.class_pixel_distribution(str(mdir), 7)
    rj, rp = _both(tmp_path, lambda T, d: T.remap_masks(str(mdir), str(d), {6: 0, 1: 2}))
    assert rj == rp == 2


def test_calibrate(tmp_path, video):
    assert P.scale_from_two_points((0, 0), (3, 4), 10.0) == J.scale_from_two_points(
        (0, 0), (3, 4), 10.0) == 2.0
    with pytest.raises(ValueError):
        P.scale_from_two_points((1, 1), (1, 1), 5.0)
    for n in (5, 30):
        roi = P.propose_roi_from_video(video, sample_frames=n)
        assert roi == J.propose_roi_from_video(video, sample_frames=n)
    assert roi["x"] <= 40 and roi["x"] + roi["w"] >= 50
    _both(tmp_path, lambda T, d: (d.mkdir(), T.save_roi_json(str(d / "roi.json"), 1, 2, 3, 4)))
    assert P.load_roi_json(str(tmp_path / "p" / "roi.json"))["w"] == 3


def test_hard_negatives(tmp_path, video):
    vdir = tmp_path / "videos"
    vdir.mkdir()
    shutil.copy(video, vdir / "a.mp4")
    shutil.copy(video, vdir / "b.avi")
    rj, rp = _both(tmp_path / "out", lambda T, d: T.create_hard_negative_dataset(
        str(vdir), str(d), num_frames=5, frame_size=(64, 48)))
    assert rj == rp == 4     # 5 // 2 videos: 2 frames each


def test_labelme_conversion_and_prepare_dataset(tmp_path, rng):
    ann = {"imageHeight": 40, "imageWidth": 50, "shapes": [
        {"label": "cable", "points": [[5, 5], [30, 5], [30, 35], [5, 35]]},
        {"label": "thin_defect", "points": [[10, 10], [20, 10], [20, 20], [10, 20]]},
        {"label": "bulge_defect", "points": [[0, 0], [4, 0], [4, 4], [0, 4]]},
        {"label": "unknown_thing", "points": [[40, 0], [49, 0], [49, 9], [40, 9]]}]}
    p = tmp_path / "a.json"
    p.write_text(json.dumps(ann))
    assert np.array_equal(plabelme.json_to_mask(str(p)), jlabelme.json_to_mask(str(p)))
    assert plabelme.CLASS_MAP == jlabelme.CLASS_MAP
    assert plabelme.CLASS_NAME_MAPPING == jlabelme.CLASS_NAME_MAPPING

    lm, images = tmp_path / "labelme", tmp_path / "images"
    lm.mkdir()
    images.mkdir()
    for i in range(12):
        cv2.imwrite(str(images / f"s{i:02d}.png"), (rng.random((40, 50, 3)) * 255).astype(np.uint8))
        doc = dict(ann, shapes=[dict(ann["shapes"][0], points=[[i, i], [30, i], [30, 35]])])
        (lm / f"s{i:02d}.json").write_text(json.dumps(doc))
    for seed in (42, 7):
        rel = lambda res, root: {k: [tuple(os.path.relpath(x, root) for x in pair)
                                     for pair in v] for k, v in res.items()}
        rj, rp = _both(tmp_path / f"seed{seed}", lambda T, d: rel((
            jlabelme if T is J else plabelme).prepare_dataset(str(lm), str(images), str(d),
                                                              seed=seed), d))
        assert rj == rp and len(rp["train"]) == 10 and len(rp["val"]) == 1


def test_update_dataset(tmp_path, rng):
    for d in ("raw_images", "raw_masks"):
        (tmp_path / d).mkdir()
    for i in range(10):
        cv2.imwrite(str(tmp_path / "raw_images" / f"r{i}.jpg"),
                    (rng.random((24, 24, 3)) * 255).astype(np.uint8))
        cv2.imwrite(str(tmp_path / "raw_masks" / f"r{i}.png"),
                    (rng.random((24, 24)) * 2).astype(np.uint8))
    for seed in (42, 3):
        rj, rp = _both(tmp_path / f"s{seed}", lambda T, d: T.update_dataset(
            str(tmp_path / "raw_images"), str(tmp_path / "raw_masks"), str(d), seed=seed,
            val_ratio=0.2, test_ratio=0.1))
        assert rj == rp == {"train": 7, "val": 2, "test": 1}
        # the files are copied with their times: the same split, file for file
        assert sorted(os.listdir(tmp_path / f"s{seed}" / "p" / "val" / "images")) == \
            sorted(os.listdir(tmp_path / f"s{seed}" / "j" / "val" / "images"))


def test_render_masks(tmp_path, rng):
    for d in ("images", "masks"):
        (tmp_path / d).mkdir()
    for i in range(3):
        cv2.imwrite(str(tmp_path / "images" / f"x{i}.jpg"),
                    (rng.random((32, 32, 3)) * 255).astype(np.uint8))
        cv2.imwrite(str(tmp_path / "masks" / f"x{i}.png"),
                    (rng.random((32, 32)) * 3).astype(np.uint8))
    rj, rp = _both(tmp_path / "viz", lambda T, d: T.render_masks(
        str(tmp_path / "images"), str(tmp_path / "masks"), str(d), limit=2))
    assert rj == rp == 2


def test_annotate_roundtrip(tmp_path, rng):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    cv2.imwrite(str(img_dir / "f_000.png"), (rng.random((64, 96, 3)) * 255).astype(np.uint8))

    def run(T, d):
        ann = T.load_annotations(str(d / "ann"))
        T.add_boxes(ann, 0, "f_000.png", [[40, 30, 10, 12], [50, 5, 55, 8]])
        T.add_boxes(ann, 0, "f_000.png", [[60.4, 20, 80, 40.6]])
        T.add_boxes(ann, 1, "missing.png", [[1, 1, 30, 30]], replace=True)
        T.save_annotations(str(d / "ann"), ann)
        n = T.annotations_to_labelme(T.load_annotations(str(d / "ann")), str(img_dir),
                                     str(d / "labelme"))
        return ann, n

    rj, rp = _both(tmp_path, run)
    assert rj == rp and rp[0]["0"]["burr_regions"] == [[10, 12, 40, 30], [60, 20, 80, 41]]
    assert rp[1] == 1
    mask = plabelme.json_to_mask(str(tmp_path / "p" / "labelme" / "f_000.json"))
    assert np.array_equal(mask, jlabelme.json_to_mask(str(tmp_path / "j" / "labelme" / "f_000.json")))
    assert P.rectangles_to_labelme("a/b.png", (5, 6), [(1, 2, 3, 4)]) == \
        J.rectangles_to_labelme("a/b.png", (5, 6), [(1, 2, 3, 4)])


def test_summarize_checkpoints_of_a_port_train_run(tmp_path, capsys):
    """Over the checkpoints of the port's `cli train`: the same summary and
    table as the JAX package's summarizer."""
    split = cs.write_split(tmp_path / "split", 4, 2, 40, 56)
    ck = tmp_path / "ck"
    assert pmain(["train", "--recipe", "3class_advanced", "--data-root", split, "--output",
                  str(ck), "--epochs", "2", "--batch", "2", "--image-size", "32",
                  "--device", "cpu"]) == 0
    capsys.readouterr()
    want = J.summarize_checkpoints(str(ck))
    want_out = capsys.readouterr().out
    got = P.summarize_checkpoints(str(ck))
    assert got == want and capsys.readouterr().out == want_out
    assert set(got["checkpoints"]) >= {"best", "last"} and got["history"]["epochs"] == 2


def _drag(mod, sess, x1, y1, x2, y2):
    sess.on_mouse(mod.MOUSE_DOWN, x1, y1)
    sess.on_mouse(mod.MOUSE_MOVE, (x1 + x2) // 2, (y1 + y2) // 2)
    sess.on_mouse(mod.MOUSE_UP, x2, y2)


def _annotation_session(mod, frames, out):
    """tests/test_tools.py's event sequence; returns the actions, the states
    and the rendered frames along the way."""
    sess = mod.AnnotationSession(str(frames), str(out))
    seen = [(sess.idx, sess.filename)]
    _drag(mod, sess, 10, 12, 40, 30)
    sess.on_mouse(mod.MOUSE_DOWN, 60, 20)
    sess.on_mouse(mod.MOUSE_MOVE, 70, 30)
    renders = [sess.render()]                    # a drag in flight, drawn
    sess.on_mouse(mod.MOUSE_UP, 80, 40)
    _drag(mod, sess, 50, 5, 55, 8)
    seen.append([list(b) for b in sess.boxes])
    renders.append(sess.render())
    for key in (ord("u"), mod.KEY_SPACE):
        seen.append((sess.on_key(key), sess.idx, list(sess.boxes)))
    _drag(mod, sess, 5, 5, 30, 30)
    for key in (ord("c"), ord("n"), mod.KEY_LEFT, 3, 2, mod.KEY_RIGHT, ord("z"), ord("s"),
                ord("q")):
        seen.append((sess.on_key(key), sess.idx, list(sess.boxes), sess.done))
    again = mod.AnnotationSession(str(frames), str(out))
    seen.append(again.boxes)
    renders.append(again.render())
    return seen, renders


def test_interactive_sessions(tmp_path, rng):
    """The three sessions fed the same synthetic events: the same actions
    and states, the same rendered frames bit for bit, the same files."""
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(3):
        cv2.imwrite(str(frames / f"frame_{i:06d}.jpg"),
                    (rng.random((64, 96, 3)) * 255).astype(np.uint8))
    assert PI.list_frames(str(frames)) == JI.list_frames(str(frames))
    (sj, rj), (sp, rp) = _both(tmp_path / "ann", lambda T, d: _annotation_session(
        JI if T is J else PI, frames, d))
    assert sp == sj
    assert all(np.array_equal(a, b) for a, b in zip(rp, rj)) and len(rp) == len(rj) == 3

    frame = (rng.random((64, 96, 3)) * 255).astype(np.uint8)

    def roi_and_scale(mod, d):
        d.mkdir(parents=True)
        sess = mod.RoiCalibrationSession(frame, out_path=str(d / "roi.json"))
        _drag(mod, sess, 30, 10, 10, 50)
        out = [dict(sess.roi), sess.render()]
        out += [sess.on_key(ord("r")), sess.roi, sess.on_key(ord("s"))]
        _drag(mod, sess, 12, 8, 44, 40)
        out += [sess.render(), sess.on_key(13), sess.done, sess.saved]
        sc = mod.ScaleCalibrationSession(frame, known_mm=50.0)
        sc.on_mouse(mod.MOUSE_DOWN, 10, 10)
        out += [sc.render(), sc.on_key(ord("r")), sc.points]
        sc.on_mouse(mod.MOUSE_DOWN, 10, 10)
        sc.on_mouse(mod.MOUSE_MOVE, 50, 50)
        sc.on_mouse(mod.MOUSE_DOWN, 70, 90)
        out += [sc.done, sc.mm_per_px, sc.render(), sc.on_key(ord("q"))]
        return out

    rj, rp = _both(tmp_path / "cal", lambda T, d: roi_and_scale(JI if T is J else PI, d))
    for a, b in zip(rp, rj):
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b), (a, b)


def test_interactive_needs_display(tmp_path, rng, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert not PI.gui_available()
    frames = tmp_path / "frames"
    frames.mkdir()
    cv2.imwrite(str(frames / "frame_000000.jpg"), (rng.random((32, 48, 3)) * 255).astype(np.uint8))
    with pytest.raises(RuntimeError, match="headless"):
        PI.run_window(PI.AnnotationSession(str(frames), str(tmp_path / "ann")))
    for tool in ("annotate", "calibrate-roi", "calibrate-scale"):
        argv = ["tools", tool, "--interactive", "--frames-dir", str(frames), "--out",
                str(tmp_path / "ann"), "--filename", str(frames / "frame_000000.jpg"),
                "--known-mm", "5"]
        with pytest.raises(RuntimeError, match="headless"):
            pmain(argv)
    with pytest.raises(SystemExit, match="no --interactive mode"):
        pmain(["tools", "audit", "--interactive"])


def test_single_image_inference_matches_jax(tmp_path, rng):
    """At 32², a SimpleUNet from the JAX package's PRNGKey(0) weights: the
    class map equals the JAX one but where the JAX logits' top two lie
    within chip_smoke.TIE_GAP; predict_and_save writes the three files."""
    from unet_tpu.models import SimpleUNet as JSimpleUNet
    from unet_tpu.ops import color as jcolor
    from unet_tpu.ops import image as jimage
    from unet_tpu_torch.models import SimpleUNet
    from unet_tpu_torch.models.convert import state_dict_from_flax

    jm = JSimpleUNet(num_classes=3)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                 np.zeros((1, 32, 32, 3), np.float32)))
    tm = SimpleUNet(num_classes=3)
    tm.load_state_dict(state_dict_from_flax(variables, "simple_unet"))
    jinf = J.SingleImageInference(jm, variables, input_size=32, num_classes=3)
    pinf = P.SingleImageInference(tm, input_size=32, num_classes=3, device="cpu")
    img = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    got, want = pinf.predict(img), jinf.predict(img)
    assert got.shape == (48, 64) and got.dtype == np.uint8

    x = jimage.resize_bilinear(jcolor.bgr2rgb(img[None].astype(np.float32)), (32, 32)) / 255.0
    jlogits = torch.from_numpy(np.asarray(jm.apply(variables, x)).transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        plogits = tm(torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2))
    ties = cs.tie_pixels(jlogits)
    flips = plogits.argmax(1) != jlogits.argmax(1)
    assert not bool((flips & ~ties).any())
    foot = cv2.resize(ties[0].numpy().astype(np.uint8), (64, 48),
                      interpolation=cv2.INTER_NEAREST).astype(bool)
    assert np.array_equal(got[~foot], want[~foot])
    if not bool(flips.any()):
        assert np.array_equal(got, want)

    p = tmp_path / "img.jpg"
    cv2.imwrite(str(p), img)
    paths = pinf.predict_and_save(str(p), str(tmp_path / "out"))
    assert sorted(paths) == ["color", "mask", "overlay"]
    assert all(os.path.exists(v) for v in paths.values())
    assert np.array_equal(cv2.imread(paths["mask"], cv2.IMREAD_UNCHANGED),
                          pinf.predict(cv2.imread(str(p))))


# ---------------------------------------------------------------------------
# cli tools: each of the 15 through both CLIs

def _cli_inputs(tmp_path, rng, video):
    raw = tmp_path / "in"
    for d in ("images", "masks", "labelme", "videos", "frames"):
        (raw / d).mkdir(parents=True)
    for i in range(5):
        cv2.imwrite(str(raw / "images" / f"r{i}.jpg"),
                    (rng.random((24, 32, 3)) * 255).astype(np.uint8))
        m = (rng.random((24, 32)) * 3).astype(np.uint8)
        m[0, 0] = 9 if i == 0 else m[0, 0]
        cv2.imwrite(str(raw / "masks" / f"r{i}.png"), m)
        (raw / "labelme" / f"r{i}.json").write_text(json.dumps({
            "imageHeight": 24, "imageWidth": 32,
            "shapes": [{"label": "cable", "points": [[2, 2], [20, 2], [20, 20 - i], [2, 20]]}]}))
    shutil.copy(video, raw / "videos" / "a.mp4")
    (raw / "ck").mkdir()
    (raw / "ck" / "best.meta.json").write_text(json.dumps({"epoch": 7, "best_miou": 0.81}))
    (raw / "ck" / "last.meta.json").write_text(json.dumps({"epoch": 9, "best_miou": 0.79}))
    (raw / "ck" / "training_history.json").write_text(json.dumps(
        {"history": {"miou": [0.5, 0.81, 0.79], "loss": [1.0, 0.5, 0.4]}}))
    return raw


def _tool_argv(raw, out):
    """{tool: argv} with every output under `out`."""
    return {
        "extract-frames": ["--video", str(raw / "videos" / "a.mp4"), "--out", str(out / "f"),
                           "--fps", "10", "--dedup", "0.9", "--roi", "0,0,80,60"],
        "audit": ["--labelme-dir", str(raw / "labelme"), "--out", str(out / "audit.json")],
        "class-dist": ["--mask-dir", str(raw / "masks"), "--num-classes", "10"],
        "remap-masks": ["--mask-dir", str(raw / "masks"), "--out", str(out / "remap"),
                        "--mapping", "9:0,2:1"],
        "prepare-dataset": ["--labelme-dir", str(raw / "labelme"), "--images-dir",
                            str(raw / "images"), "--out", str(out / "prep")],
        "hard-negatives": ["--videos-dir", str(raw / "videos"), "--out", str(out / "hn"),
                           "--num-frames", "3"],
        "calibrate-roi": ["--video", str(raw / "videos" / "a.mp4"), "--out",
                          str(out / "roi.json")],
        "calibrate-scale": ["--points", "0,0,30,40", "--known-mm", "25", "--out",
                            str(out / "scale.json")],
        "diagnose-mask": ["--mask-dir", str(raw / "masks"), "--num-classes", "3",
                          "--resize", "12,16"],
        "update-dataset": ["--images-dir", str(raw / "images"), "--mask-dir",
                           str(raw / "masks"), "--out", str(out / "ds"), "--seed", "5",
                           "--val-ratio", "0.2", "--test-ratio", "0.2"],
        "render-masks": ["--images-dir", str(raw / "images"), "--mask-dir", str(raw / "masks"),
                         "--out", str(out / "viz"), "--limit", "3"],
        "annotate": ["--out", str(out / "ann"), "--frame-id", "0", "--filename", "r0.jpg",
                     "--box", "1,2,20,20", "--box", "3,3,5,5"],
        "annotate-to-labelme": ["--annotations-dir", str(out / "ann"), "--images-dir",
                                str(raw / "images"), "--out", str(out / "lm")],
        "summarize-checkpoints": ["--ckpt-dir", str(raw / "ck")],
    }


def test_cli_tools_match_jax(tmp_path, rng, video, capsys):
    """Each tool but render-predictions through both CLIs: the same stdout
    (paths aside) and the same files; render-predictions (a model of each
    package's own random weights) writes one grid an image."""
    raw = _cli_inputs(tmp_path, rng, video)
    for pkg, main in (("j", jmain), ("p", pmain)):
        out = tmp_path / pkg
        for tool, argv in _tool_argv(raw, out).items():
            assert main(["tools", tool] + argv) == 0, (pkg, tool)
            text = capsys.readouterr().out.replace(str(out), "OUT")
            (tmp_path / f"{pkg}_stdout").mkdir(exist_ok=True)
            (tmp_path / f"{pkg}_stdout" / tool).write_text(text)
    _same_tree(tmp_path / "j_stdout", tmp_path / "p_stdout")
    _same_tree(tmp_path / "j", tmp_path / "p")
    assert len(os.listdir(tmp_path / "p" / "ds" / "val" / "images")) == 1

    torch.save(cs.seeded_nested_unet().state_dict(), tmp_path / "m.pth")
    assert pmain(["tools", "render-predictions", "--images-dir", str(raw / "images"),
                  "--mask-dir", str(raw / "masks"), "--model", str(tmp_path / "m.pth"),
                  "--image-size", "32", "--out", str(tmp_path / "pred"), "--limit", "2",
                  "--device", "cpu"]) == 0
    assert len(os.listdir(tmp_path / "pred")) == 2
    assert "rendered 2 comparison grids" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["annotate", "--out", "x"], ["summarize-checkpoints"], ["render-masks"],
    ["diagnose-mask", "--num-classes", "3"], ["calibrate-scale", "--points", "0,0,1,1"],
    ["remap-masks", "--mask-dir", "m", "--out", "o"]], ids=lambda a: a[0])
def test_cli_tools_required_flags(argv):
    """tests/test_tools.py::test_cli_tools_required_flags: the same refusal,
    word for word, before any tool runs."""
    with pytest.raises(SystemExit) as want:
        jmain(["tools"] + argv)
    with pytest.raises(SystemExit) as got:
        pmain(["tools"] + argv)
    assert str(got.value) == str(want.value) and "is required" in str(got.value)
