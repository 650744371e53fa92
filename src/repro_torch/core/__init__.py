"""Linear-layer API, precision policies, and 2-D Jigsaw: the mesh, its
sharding rules, the differentiable collectives and the Cannon products."""
