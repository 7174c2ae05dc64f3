"""Plot utilities (host side): the validation-sample and eval figures.

Counterpart of the parts of `state_policy_diffusionmodel_tpu/utils/
plotting.py` that the port's training hook and eval suite call: the
prediction-overlay and action-comparison figures, figure-to-image export
and the autoencoder CLI's reconstruction grid. matplotlib (and the Pillow
it depends on) is imported only when a figure is made, since the GPU
machine has neither. The denoising animations wait for the CLIs that use
them.
"""

from __future__ import annotations

import io

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
