"""robotics — the drone runtime: the native simulator, depth maps and FIFO
link (``runtime``), the real-drone adapter (``drone_api``), the avoidance
controller (``control``) and keyboard teleop (``teleop``)."""
