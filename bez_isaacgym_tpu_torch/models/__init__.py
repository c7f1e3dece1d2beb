"""Robot models: URDF parsing and the flat articulated-body model (numpy)."""

from bez_isaacgym_tpu_torch.models.robot import RobotModel, DynParams  # noqa: F401
from bez_isaacgym_tpu_torch.models.urdf import RobotSpec, parse_urdf  # noqa: F401
