"""Host utilities of the port: meshing dumps and the step timer."""
