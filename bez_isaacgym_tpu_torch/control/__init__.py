"""Classical model-based control stack: walking engine, IK, PID, keyframes.

Port of `bez_isaacgym_tpu/control/`: body-path planning (Bezier + rotate-in-
place), footstep phase machine with parabolic swing, torso sway, closed-form
6-DOF leg IK, IMU pitch PIDs and keyframe playback run host-side in numpy
(copies of the JAX package's modules); the inverse-dynamics feedforward
runs in torch on the port's dynamics.  The joint plans feed the port's
tasks and solvers (MPC warm starts, tracking oracles).
"""

from bez_isaacgym_tpu_torch.control.transformation import Transformation  # noqa: F401
from bez_isaacgym_tpu_torch.control.soccerbot import Soccerbot  # noqa: F401
from bez_isaacgym_tpu_torch.control.controller import SoccerbotController  # noqa: F401
