"""Headless model renderer (viz/render.py) + model_viewer CLI."""

import os

import numpy as np
import pytest

pytest.importorskip("matplotlib")  # the renderer's optional dependency

from test_models import make_simple_rec  # noqa: E402
from privacy_preserving_sfm_tpu.viz import (  # noqa: E402
    render_model, render_turntable,
)


def _rec_with_points():
    rec, pts = make_simple_rec()
    for j in range(len(pts)):
        rec.add_point3d(pts[j], [(iid, j) for iid in range(1, 5)])
    return rec


def test_render_single_view(tmp_path):
    rec = _rec_with_points()
    out = str(tmp_path / "model.png")
    render_model(rec, out, color_by="track")
    assert os.path.getsize(out) > 1000
    # PNG magic bytes.
    with open(out, "rb") as f:
        assert f.read(4) == b"\x89PNG"


def test_render_color_modes_and_turntable(tmp_path):
    rec = _rec_with_points()
    for mode in ("error", "depth"):
        out = str(tmp_path / f"{mode}.png")
        render_model(rec, out, color_by=mode)
        assert os.path.getsize(out) > 1000
    frames = render_turntable(rec, str(tmp_path / "turn"), num_frames=3)
    assert len(frames) == 3 and all(os.path.getsize(p) > 1000
                                    for p in frames)


def test_model_viewer_cli(tmp_path):
    from privacy_preserving_sfm_tpu.exe.ppsfm import main

    rec = _rec_with_points()
    model_dir = str(tmp_path / "sparse")
    os.makedirs(model_dir)
    rec.write_text(model_dir)
    out = str(tmp_path / "view.png")
    main(["model_viewer", "--input_path", model_dir,
          "--output_path", out, "--color_by", "depth"])
    assert os.path.getsize(out) > 1000


def test_render_empty_model(tmp_path):
    from privacy_preserving_sfm_tpu.models.reconstruction import (
        Reconstruction,
    )

    out = str(tmp_path / "empty.png")
    render_model(Reconstruction(), out, title="empty")
    assert os.path.getsize(out) > 100


def test_interactive_html_export(tmp_path):
    """Self-contained HTML viewer (viz/interactive.py): payload embeds
    the decimated point cloud + frusta and the file opens standalone."""
    import base64
    import json
    import re

    from privacy_preserving_sfm_tpu.viz.interactive import export_html

    rec = _rec_with_points()
    out = str(tmp_path / "viewer.html")
    export_html(rec, out)
    html = open(out).read()
    assert "<canvas" in html and "__PAYLOAD__" not in html
    payload = json.loads(re.search(r"const D=(\{.*?\});\n", html).group(1))
    xyz = np.frombuffer(base64.b64decode(payload["xyz"]), np.float32)
    assert xyz.shape[0] == 3 * payload["n_points"] > 0
    assert payload["stats"]["images"] == 4
    fr = np.frombuffer(base64.b64decode(payload["frusta"]), np.float32)
    assert fr.shape[0] == 4 * 8 * 2 * 3  # 4 cams x 8 segs x 2 ends x xyz


def test_model_viewer_cli_html(tmp_path):
    from privacy_preserving_sfm_tpu.exe.ppsfm import main

    rec = _rec_with_points()
    model_dir = str(tmp_path / "sparse")
    os.makedirs(model_dir)
    rec.write_text(model_dir)
    out = str(tmp_path / "viewer.html")
    main(["model_viewer", "--input_path", model_dir, "--html", out])
    assert os.path.getsize(out) > 4000
