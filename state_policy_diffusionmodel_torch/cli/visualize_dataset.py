"""Dataset inspection figures, PyTorch port (the reference's
scripts/visualize_{position,images,actions}.py, with the normalized-window
checks of visualize_position.py:150-264).

    python -m state_policy_diffusionmodel_torch.cli.visualize_dataset \
        D/S.zarr --what positions|actions|images|normalized [--episode 0]

Counterpart of the JAX package's `cli/visualize_dataset.py`, with its
flags. The store is read through the port's `load_zarr` (uncompressed,
zlib or blosc). `normalized_windows` and `episode_frames` compute what the
figures show without matplotlib; `figure` draws it and `main` writes the
PNG (matplotlib and Pillow needed).
"""

from __future__ import annotations

import argparse

import numpy as np

WHATS = ["positions", "actions", "images", "normalized"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset", help="zarr dataset path (dir or .zip)")
    p.add_argument("--what", default="positions", choices=WHATS)
    p.add_argument("--episode", type=int, default=0)
    p.add_argument("--n_windows", type=int, default=4,
                   help="windows sampled for --what normalized")
    p.add_argument("--window_len", type=int, default=100,
                   help="window length for --what normalized "
                        "(visualize_position.py:150 sequence_length)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def normalized_windows(buf, n_windows: int = 4, window_len: int = 100,
                       seed: int = 0) -> dict:
    """The per-window normalization check (visualize_position.py:150-264):
    `n_windows` windows of `window_len` frames drawn with a seeded
    permutation, each raw, min-max normalized by its own stats and centred
    at its first frame, and the mean of the windows' min and max (the
    inputs of the averaged-stats quirk, load_data.py:58-78)."""
    from ..data import normalize as N

    pos_all = np.asarray(buf.data["position"], np.float32)
    ends = np.asarray(buf.episode_ends, np.int64)
    idx = N.create_sample_indices_sparse(ends, window_len, 1)
    picks = np.random.default_rng(seed).permutation(len(idx))[:n_windows]
    windows, mins, maxs = [], [], []
    for w in picks:
        start, end, _, _ = idx[w]
        sample = pos_all[start:end]
        stats = N.get_data_stats(sample)
        mins.append(float(np.min(stats["min"])))
        maxs.append(float(np.max(stats["max"])))
        normed = N.normalize_data(sample, stats)
        windows.append((int(w), sample, normed, normed - normed[0]))
    return {"windows": windows, "mean_min": float(np.mean(mins)),
            "mean_max": float(np.mean(maxs))}


def episode_frames(ep: dict, n: int = 16):
    """(indices, uint8 frames) of n frames spread over the episode."""
    imgs = ep["img"]
    idxs = np.linspace(0, len(imgs) - 1, n).astype(int)
    frames = []
    for i in idxs:
        frame = np.asarray(imgs[i])
        if frame.max() <= 1.5:
            frame = (frame * 255).astype(np.uint8)
        frames.append(frame)
    return idxs, frames


def figure(buf, what: str, episode: int = 0, n_windows: int = 4,
           window_len: int = 100, seed: int = 0):
    """The matplotlib figure of `what` for the store `buf`."""
    from ..utils.plotting import _plt

    plt = _plt()
    ep = buf.get_episode(episode)
    if what == "positions":
        fig = plt.figure(figsize=(7, 7))
        pos = ep["position"]
        plt.plot(pos[:, 0], pos[:, 1], ".-", ms=2)
        plt.axis("equal")
        plt.grid()
        plt.title("episode positions")
    elif what == "normalized":
        res = normalized_windows(buf, n_windows, window_len, seed)
        n = len(res["windows"])
        fig, axes = plt.subplots(n, 3, figsize=(12, 3 * n), squeeze=False)
        for row, (w, *arrays) in enumerate(res["windows"]):
            for ax, arr, title in zip(axes[row], arrays,
                                      ("raw", "normalized", "centered")):
                ax.plot(arr[:, 0], arr[:, 1])
                ax.set_title(f"window {w}: {title}")
                ax.grid(True)
            axes[row][2].scatter([0], [0], c="r")
        print(f"mean per-window min {res['mean_min']:.3f} "
              f"max {res['mean_max']:.3f} over {n} windows")
        fig.tight_layout()
    elif what == "actions":
        fig, axes = plt.subplots(3, 1, figsize=(10, 7), sharex=True)
        for i, name in enumerate(["steer", "gas", "brake"]):
            axes[i].plot(ep["action"][:, i])
            axes[i].set_ylabel(name)
        axes[-1].set_xlabel("step")
    elif what == "images":
        idxs, frames = episode_frames(ep)
        fig, axes = plt.subplots(4, 4, figsize=(10, 10))
        for ax, i, frame in zip(axes.flat, idxs, frames):
            ax.imshow(frame)
            ax.set_title(str(i))
            ax.axis("off")
    else:
        raise ValueError(what)
    return fig


def main(argv=None) -> str:
    """Write the figure as a PNG; returns its path."""
    args = parse_args(argv)
    from ..data.replay_buffer import load_zarr
    from ..utils.plotting import _plt, fig_to_array, save_png

    buf = load_zarr(args.dataset)
    out = args.out or f"dataset_{args.what}_ep{args.episode}.png"
    fig = figure(buf, args.what, args.episode, args.n_windows,
                 args.window_len, args.seed)
    save_png(fig_to_array(fig), out)
    _plt().close(fig)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
