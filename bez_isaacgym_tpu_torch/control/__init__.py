"""Classical control: keyframe skill playback and MPC warm starts."""
