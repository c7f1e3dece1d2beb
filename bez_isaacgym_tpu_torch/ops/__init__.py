"""Physics ops: quaternions, kinematics, dynamics, contact, solves, the
plain engine, the CUDA substep kernel, sensors."""
