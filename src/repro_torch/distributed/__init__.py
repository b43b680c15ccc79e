"""Distribution: sharding rules, the collective matmul, the tensor-parallel
layout of the served decoder."""
