"""Distribution: the sharding rules on a DeviceMesh (``sharding``) and the
data-parallel row gather of the MoE layer (``groups``)."""
