#!/usr/bin/env python3
"""WASD keyboard teleoperation of a serial robot base, built on the PyTorch
port's native library (the counterpart of teleop.py).

Reads keys from stdin, smooths (v, w) commands with an EMA, and writes
framed packets ``[0xA5, float32 v, float32 w, crc8]`` to a serial port.
The CRC-8 comes from gslam_tpu_torch.io.native (the C++ library, with a
Python fallback built in); pyserial is optional: without it, packets go to
a file or fifo for testing.

    python teleop_torch.py --port /dev/ttyUSB0
    python teleop_torch.py --port /tmp/teleop.bin   # file sink dry-run
"""

from __future__ import annotations

import argparse
import struct
import sys
import time

from gslam_tpu_torch.io.native import crc8

START_BYTE = 0xA5

KEY_VELOCITIES = {
    "w": (0.2, 0.0),
    "s": (-0.2, 0.0),
    "a": (0.0, 0.8),
    "d": (0.0, -0.8),
    " ": (0.0, 0.0),
}


def make_packet(v: float, w: float) -> bytes:
    body = bytes([START_BYTE]) + struct.pack("<ff", v, w)
    return body + bytes([crc8(body)])


class CommandSmoother:
    """EMA smoothing of velocity commands (reference SerialNode)."""

    def __init__(self, alpha: float = 0.6):
        self.alpha = alpha
        self.v = 0.0
        self.w = 0.0

    def update(self, v_target: float, w_target: float) -> tuple[float, float]:
        self.v = self.alpha * self.v + (1 - self.alpha) * v_target
        self.w = self.alpha * self.w + (1 - self.alpha) * w_target
        return self.v, self.w


def open_sink(port: str, baud: int):
    """A pyserial port where pyserial is installed and opens it; else the
    path opened as an unbuffered binary file."""
    try:
        import serial

        return serial.Serial(port, baud, timeout=0.1)
    except (ImportError, OSError):  # no pyserial, or not a serial device
        return open(port, "wb", buffering=0)


def main(argv=None):
    import select
    import termios
    import tty

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", default="/dev/ttyUSB0")
    ap.add_argument("--baud", type=int, default=115200)
    ap.add_argument("--rate", type=float, default=20.0)
    args = ap.parse_args(argv)

    sink = open_sink(args.port, args.baud)
    smoother = CommandSmoother()
    print("WASD to drive, space to stop, q to quit")

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        target = (0.0, 0.0)
        next_tick = time.time()
        while True:
            if select.select([sys.stdin], [], [], 0.0)[0]:
                ch = sys.stdin.read(1).lower()
                if ch == "q":
                    break
                if ch in KEY_VELOCITIES:
                    target = KEY_VELOCITIES[ch]
            v, w = smoother.update(*target)
            sink.write(make_packet(v, w))
            next_tick += 1.0 / args.rate
            time.sleep(max(0.0, next_tick - time.time()))
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sink.write(make_packet(0.0, 0.0))
        sink.close()


if __name__ == "__main__":
    main()
