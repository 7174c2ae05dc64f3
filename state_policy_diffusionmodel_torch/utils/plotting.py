"""Plot and animation utilities (host side).

Counterpart of `state_policy_diffusionmodel_tpu/utils/plotting.py`: the
prediction-overlay and action-comparison figures, figure-to-image export,
the autoencoder CLI's reconstruction grid, the denoising animations
(`plt_toVideo` of the reference) and frame export to a video: an .mp4
through ffmpeg where it is on the PATH, else a .gif through Pillow.
matplotlib and Pillow are imported only when a figure or a file is made,
since the GPU machine has neither (nor ffmpeg).
"""

from __future__ import annotations

import io
import os
import shutil
import subprocess
import tempfile
from typing import Sequence

import numpy as np


def _plt():
    """matplotlib.pyplot on the agg backend; raises ModuleNotFoundError,
    naming the figures, where matplotlib is not installed."""
    try:
        import matplotlib
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            "figures need matplotlib, which is not installed here") from e
    matplotlib.use("agg")
    import matplotlib.pyplot as plt
    return plt


def fig_to_array(fig) -> np.ndarray:
    """(H, W, 3) uint8 of a matplotlib figure, rendered as a 100-dpi PNG."""
    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=100)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"))


def save_png(arr: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def save_animation(frames: Sequence[np.ndarray], path: str,
                   fps: int = 10) -> str:
    """Write uint8 RGB frames to `path` as an .mp4 through ffmpeg, or as a
    .gif through Pillow (an .mp4 path becomes .gif where ffmpeg is not on
    the PATH). Returns the path written."""
    from PIL import Image

    if path.endswith(".mp4") and shutil.which("ffmpeg") is None:
        path = path[:-4] + ".gif"
    if path.endswith(".gif"):
        imgs = [Image.fromarray(np.asarray(f)) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return path
    with tempfile.TemporaryDirectory() as td:
        for i, f in enumerate(frames):
            Image.fromarray(np.asarray(f)).save(
                os.path.join(td, f"f{i:05d}.png"))
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-framerate", str(fps),
             "-i", os.path.join(td, "f%05d.png"), "-pix_fmt", "yuv420p",
             "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2", path],
            check=True)
    return path


def plot_prediction_overlay(positions_gt, positions_obs, positions_pred,
                            positions_inpaint=None, title: str = ""):
    """The validation figure of `_plot_positions`
    (diffusion_ddpm.py:358-390)."""
    plt = _plt()
    fig = plt.figure()
    plt.plot(positions_gt[:, 0], positions_gt[:, 1], "g.", label="Ground Truth")
    plt.plot(positions_obs[:, 0], positions_obs[:, 1], "b.", label="Observation")
    n = len(positions_pred)
    colors = plt.get_cmap("viridis", n)(np.arange(n) / max(n - 1, 1))
    plt.scatter(positions_pred[:, 0], positions_pred[:, 1], color=colors,
                s=10, label="Predicted")
    if positions_inpaint is not None:
        plt.scatter(positions_inpaint[:, 0], positions_inpaint[:, 1],
                    color="r", s=20, label="Inpainted")
    plt.xlabel("X Position")
    plt.ylabel("Y Position")
    plt.legend(loc="upper right")
    plt.grid()
    plt.axis("equal")
    plt.title(title)
    return fig


def plot_action_comparison(actions_pred, actions_gt, inpaint_horizon: int,
                           title: str = ""):
    """`_plot_actions` (diffusion_ddpm.py:392-422)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    names = ["Steering input", "Acceleration input", "Breaking input"]
    for i, (ax, name) in enumerate(zip(axes, names)):
        ax.plot(actions_gt[:, i], c="b", label="Ground Truth")
        ax.scatter(np.arange(len(actions_pred)), actions_pred[:, i], c="r",
                   s=10, label="Predicted")
        ax.axvspan(0, inpaint_horizon, alpha=0.2, color="red")
        ax.axvspan(inpaint_horizon, len(actions_pred), alpha=0.2, color="green")
        ax.set_title(name)
    axes[0].legend()
    fig.suptitle(title)
    return fig


def denoising_frames(history: np.ndarray, every: int = 10,
                     kind: str = "positions") -> list:
    """The frames of `denoising_animation`: sample 0 of the denoising
    history (T_steps+1, B, horizon, 5) every `every` steps, its positions
    as a scatter in fixed limits or its three action channels, each figure
    as (H, W, 3) uint8."""
    plt = _plt()
    hist = history[::every, 0]
    frames = []
    lim_pos = np.abs(history[..., :2]).max() * 1.1 + 1e-3
    for step, x in enumerate(hist):
        if kind == "positions":
            fig = plt.figure()
            plt.scatter(x[:, 0], x[:, 1], c=np.arange(len(x)), cmap="viridis")
            plt.xlim(-lim_pos, lim_pos)
            plt.ylim(-lim_pos, lim_pos)
            plt.title(f"denoising step {step * every}")
        else:
            fig, axes = plt.subplots(1, 3, figsize=(10, 3))
            for i, ax in enumerate(axes):
                ax.plot(x[:, 2 + i], "r.-")
                ax.set_ylim(-1.5, 1.5)
            fig.suptitle(f"denoising step {step * every}")
        frames.append(fig_to_array(fig))
        plt.close(fig)
    return frames


def denoising_animation(history: np.ndarray, out_path: str, fps: int = 10,
                        every: int = 10, kind: str = "positions") -> str:
    """plt_toVideo: animate the denoising history (T_steps+1, B, horizon,
    5) of sample 0 into a video; returns the path written."""
    return save_animation(denoising_frames(history, every, kind), out_path,
                          fps)


def image_grid(images: np.ndarray, path: str, ncols: int = 8) -> str:
    """Save a grid of (N, H, W, 3) float [0, 1] images (the reference's
    eval_autoencoder.py reconstruction check)."""
    plt = _plt()
    n = len(images)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(1.4 * ncols, 1.4 * nrows))
    axes = np.atleast_2d(axes)
    for i in range(nrows * ncols):
        ax = axes[i // ncols, i % ncols]
        ax.axis("off")
        if i < n:
            ax.imshow(np.clip(images[i], 0, 1))
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
