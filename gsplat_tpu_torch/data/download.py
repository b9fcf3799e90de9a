"""Dataset download helpers (the official Mip-NeRF 360 zips, a Hugging
Face mirror).

Counterpart of ``gsplat_tpu/data/download.py``. Whether the network is
reachable depends on the machine; each entry point fails with a clear
message instead of a stack trace.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import zipfile

# Official Mip-NeRF 360 release zips (https://jonbarron.info/mipnerf360/).
MIPNERF360_BASE = "https://storage.googleapis.com/gresearch/refraw360"
SCENE_TO_ZIP = {
    # 360_v2.zip scenes
    "garden": "360_v2.zip",
    "bicycle": "360_v2.zip",
    "bonsai": "360_v2.zip",
    "counter": "360_v2.zip",
    "kitchen": "360_v2.zip",
    "room": "360_v2.zip",
    "stump": "360_v2.zip",
    # extra scenes zip
    "flowers": "360_extra_scenes.zip",
    "treehill": "360_extra_scenes.zip",
}


def _fetch(url: str, dest: str) -> None:
    """wget, falling back to curl."""
    if shutil.which("wget"):
        cmd = ["wget", "-c", "-O", dest, url]
    elif shutil.which("curl"):
        cmd = ["curl", "-L", "-C", "-", "-o", dest, url]
    else:
        raise RuntimeError("neither wget nor curl is available")
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(
            f"download failed ({url}): {result.stderr.strip()[-500:]}"
        )


def download_mipnerf360_scene(scene: str, output_dir: str) -> str:
    """Download + extract one Mip-NeRF 360 scene. Returns the scene dir.

    Idempotent: skips the download when the scene directory already
    exists.
    """
    if scene not in SCENE_TO_ZIP:
        raise ValueError(
            f"unknown scene {scene!r}; choose from {sorted(SCENE_TO_ZIP)}"
        )
    os.makedirs(output_dir, exist_ok=True)
    scene_dir = os.path.join(output_dir, scene)
    if os.path.isdir(scene_dir) and os.listdir(scene_dir):
        return scene_dir

    zip_name = SCENE_TO_ZIP[scene]
    zip_path = os.path.join(output_dir, zip_name)
    if not os.path.exists(zip_path):
        _fetch(f"{MIPNERF360_BASE}/{zip_name}", zip_path)

    with zipfile.ZipFile(zip_path) as zf:
        members = [m for m in zf.namelist() if m.startswith(f"{scene}/")]
        if not members:  # zip may be flat
            members = zf.namelist()
        zf.extractall(output_dir, members=members)

    if not os.path.isdir(scene_dir):
        # Probe common alternate layouts.
        for root, dirs, _ in os.walk(output_dir):
            if scene in dirs:
                return os.path.join(root, scene)
        raise FileNotFoundError(f"scene {scene} not found after extraction")
    return scene_dir


def download_hf_dataset(
    repo_id: str = "Voxel51/gaussian_splatting",
    output_dir: str = "data/hf_gaussian_splatting",
) -> str:
    """snapshot_download a Hugging Face dataset."""
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub is not installed in this environment"
        ) from e
    return snapshot_download(
        repo_id=repo_id, repo_type="dataset", local_dir=output_dir
    )
