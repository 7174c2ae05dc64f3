"""Interactive keyboard demo, PyTorch port (the reference's manual-driving
main, envs/car_racing.py:779-835): drive the car with the
arrow keys in a matplotlib window; prints action/step/reward every 200
steps like the reference's render loop.

    python -m state_policy_diffusionmodel_torch.cli.play [--seed 0] \
        [--augmented] [--device cpu]

Keys: left/right = steer, up = gas, down = brake, r = reset, q = quit.

Counterpart of the JAX package's `cli/play.py`, plus `--device`. The key
map (`on_key`) and the step loop (`Game.tick`) are plain functions over a
`Game`, so they run without a window; `main` connects them to a
matplotlib window (an interactive backend such as TkAgg is needed).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--augmented", action="store_true",
                   help="show the augmented (behavior-lane) frame")
    p.add_argument("--fps", type=float, default=50.0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    return p.parse_args(argv)


def on_key(action: np.ndarray, flags: dict, key: str, down: bool) -> None:
    """Apply one key press (down) or release to the action (steer, gas,
    brake) and the reset/quit flags, as the reference's key handlers do."""
    if key == "left":
        action[0] = -1.0 if down else 0.0
    elif key == "right":
        action[0] = +1.0 if down else 0.0
    elif key == "up":
        action[1] = +1.0 if down else 0.0
    elif key == "down":
        action[2] = +0.8 if down else 0.0
    elif key == "r" and down:
        flags["reset"] = True
    elif key == "q" and down:
        flags["quit"] = True


class Game:
    """One env on track `seed`, driven by the key state."""

    def __init__(self, seed: int = 0, augmented: bool = False,
                 device="cuda", log=print):
        from .. import resolve_device, track
        from ..envs import car_racing as env

        self.env = env
        self.device = resolve_device(device)
        self.bank = track.stack([track.build(track.make_track(seed),
                                             device=self.device)])
        self.ids = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.augmented = augmented
        self.log = log
        self.action = np.zeros(3, np.float32)
        self.flags = {"quit": False, "reset": False}
        self.reset()

    def reset(self):
        self.state, self.res = self.env.reset(self.bank, self.ids)
        self.total, self.steps = 0.0, 0

    def frame(self) -> np.ndarray:
        """The frame on show, (96, 96, 3) uint8."""
        f = self.res.augmented if self.augmented else self.res.obs
        return f[0].cpu().numpy()

    def tick(self) -> np.ndarray:
        """One step at the current key state (a reset first if asked; a
        finished episode restarts); returns the frame to show."""
        if self.flags["reset"]:
            self.reset()
            self.flags["reset"] = False
        a = torch.from_numpy(self.action.copy()).to(self.device)[None]
        self.state, self.res = self.env.step(self.state, self.bank, self.ids,
                                             a)
        self.total += float(self.res.reward[0])
        self.steps += 1
        done = bool(self.res.done[0])
        if self.steps % 200 == 0 or done:
            self.log(f"action {self.action.tolist()} step {self.steps} "
                     f"total_reward {self.total:+0.2f}")
        if done:
            self.reset()
        return self.frame()


def main(argv=None):
    args = parse_args(argv)
    import matplotlib

    try:
        matplotlib.use("TkAgg")
    except Exception:
        pass
    import matplotlib.pyplot as plt

    game = Game(args.seed, args.augmented, args.device)
    fig, ax = plt.subplots(figsize=(5, 5))
    fig.canvas.mpl_connect("key_press_event", lambda e: on_key(
        game.action, game.flags, e.key, True))
    fig.canvas.mpl_connect("key_release_event", lambda e: on_key(
        game.action, game.flags, e.key, False))
    im = ax.imshow(game.frame())
    ax.axis("off")
    ax.set_title("arrows drive, r resets, q quits")
    plt.ion()
    plt.show()
    while not game.flags["quit"] and plt.fignum_exists(fig.number):
        im.set_data(game.tick())
        plt.pause(max(1.0 / args.fps, 1e-3))


if __name__ == "__main__":
    main()
