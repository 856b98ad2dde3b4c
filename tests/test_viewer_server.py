"""Interactive HTTP viewer: serve a scene, fetch page + frames."""

import os
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from burn_raymarching.data.image_io import decode_png
from burn_raymarching.tools.viewer_server import _ViewerState, make_handler

# A trained scene committed with the repo (the reference's scene.json format).
SCENE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "docs",
                     "artifacts", "scene_polished.json")


@pytest.fixture(scope="module")
def server():
    state = _ViewerState(SCENE, size=32,
                         model="viewer")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def test_index_page(server):
    html = urllib.request.urlopen(server + "/").read().decode()
    assert "viewer" in html and "ArrowLeft" in html


def test_frame_renders(server):
    png = urllib.request.urlopen(
        server + "/frame?yaw=0.3&pitch=0.2&dist=2.5").read()
    img = decode_png(png)
    assert img.shape == (32, 32, 3)
    assert img.max() > 0  # scene visible


def test_frame_default_params(server):
    png = urllib.request.urlopen(server + "/frame").read()
    assert png[:4] == b"\x89PNG"


def test_scene_endpoint(server):
    import json

    data = json.loads(urllib.request.urlopen(server + "/scene").read())
    assert data["num_spheres"] == 6


def test_404(server):
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(server + "/nope")


def test_progressive_low_quality_frames():
    """q=low serves the quarter-resolution dragging preview; q=full (and
    no q) serve the full size — the headless analog of the native
    viewer's continuous-motion redraw."""
    state = _ViewerState(SCENE, size=256,
                         model="viewer")
    assert state.low_size == 64
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_port}"
        low = decode_png(urllib.request.urlopen(
            base + "/frame?yaw=0.3&q=low").read())
        full = decode_png(urllib.request.urlopen(
            base + "/frame?yaw=0.3&q=full").read())
        assert low.shape == (64, 64, 3)
        assert full.shape == (256, 256, 3)
        # Same scene content: the low frame is a coarse version of full.
        assert low.max() > 0 and full.max() > 0
    finally:
        srv.shutdown()
