"""Keyboard teleoperation, headless (port of
``depth_estimation_tpu.robotics.teleop``).

Keys are read raw from stdin (arrow escape sequences decoded), or from any
iterable of key tokens a program passes in. A terminal sees no key-up
events, so a pressed key latches its control until ``h`` (hover) zeroes
it. Run as ``python -m depth_estimation_tpu_torch.robotics.teleop
[--fifo CONTROL NAVDATA] [--steps N]``.

Key map:
  w/s      pitch +1 / -1 (forward/back)
  a/d      roll  -1 / +1 (left/right)
  Up/Down  gaz   +1 / -1 (climb/descend)
  Left/Right  dyaw -0.25 / +0.25
  space    takeoff / land toggle
  h        hover (zero all controls)
  q        quit
"""

from __future__ import annotations

import sys
from typing import Callable, Iterable, Optional

ARROWS = {"[A": "UP", "[B": "DOWN", "[C": "RIGHT", "[D": "LEFT"}


def decode_keys(byte_stream: Iterable[str]):
    """Decode a character stream into key tokens ('w', 'UP', ' ', ...)."""
    it = iter(byte_stream)
    for ch in it:
        if ch == "\x1b":
            tok = ARROWS.get(next(it, "") + next(it, ""))
            if tok:
                yield tok
        else:
            yield ch


def stdin_keys():
    """Raw non-echoing stdin key tokens (needs a tty)."""
    import termios
    import tty

    if not sys.stdin.isatty():
        raise RuntimeError("stdin teleop needs a tty; pass the keys instead")
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)

    def chars():
        try:
            tty.setcbreak(fd)
            while True:
                yield sys.stdin.read(1)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)

    return decode_keys(chars())


class Teleop:
    """Latched-control keyboard teleop over any DroneAPI-shaped object
    (``SimulatedAPI``, ``FifoDroneAPI``)."""

    def __init__(self, api):
        self.api = api
        self.pitch = self.roll = self.gaz = self.dyaw = 0.0
        self.flying = False

    def handle(self, key: str) -> bool:
        """Apply one key token; returns False on quit."""
        if key == "q":
            return False
        latch = {"w": ("pitch", 1.0), "s": ("pitch", -1.0),
                 "a": ("roll", -1.0), "d": ("roll", 1.0),
                 "UP": ("gaz", 1.0), "DOWN": ("gaz", -1.0),
                 "LEFT": ("dyaw", -0.25), "RIGHT": ("dyaw", 0.25)}
        if key in latch:
            setattr(self, *latch[key])
        elif key == " ":
            if self.flying:
                self.api.land()
            else:
                self.api.takeoff()
            self.flying = not self.flying
        elif key == "h":
            self.pitch = self.roll = self.gaz = self.dyaw = 0.0
        self.api.set_control(self.pitch, self.gaz, self.roll, self.dyaw)
        return True

    def status(self) -> str:
        """The controls and the api's state, one line."""
        pos = self.api.position()
        return (f"pitch {self.pitch:+.2f} roll {self.roll:+.2f} "
                f"gaz {self.gaz:+.2f} dyaw {self.dyaw:+.2f} | "
                f"{'FLYING' if self.flying else 'LANDED'} | "
                f"pos ({pos[0]:+.2f}, {pos[1]:+.2f}, {pos[2]:+.2f})")

    def run(self, keys: Iterable[str], max_steps: Optional[int] = None,
            render: Optional[Callable[[str], None]] = None) -> int:
        """Pump the api (``next()``) once per key token. Returns the number
        of steps run."""
        steps = 0
        for key in keys:
            if not self.handle(key):
                break
            self.api.next()
            steps += 1
            if render is not None:
                render(self.status())
            if max_steps is not None and steps >= max_steps:
                break
        return steps


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="keyboard teleop (wasd + arrows + space; h=hover q=quit)")
    ap.add_argument("--fifo", nargs=2, metavar=("CONTROL", "NAVDATA"),
                    help="drive a real SDK peer over the FIFO protocol")
    ap.add_argument("--steps", type=int, default=0,
                    help="stop after N steps (0 = until q)")
    args = ap.parse_args(argv)

    if args.fifo:
        from .drone_api import FifoDroneAPI
        # teleop runs no depth rule: the link alone, on the host
        api = FifoDroneAPI(args.fifo[0], args.fifo[1], device="cpu")
    else:
        from .runtime import SimulatedAPI
        api = SimulatedAPI()

    t = Teleop(api)
    print(__doc__.split("Key map:")[1])
    steps = t.run(stdin_keys(), max_steps=args.steps or None, render=print)
    print(f"teleop: {steps} steps")
    if args.fifo:
        api.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
