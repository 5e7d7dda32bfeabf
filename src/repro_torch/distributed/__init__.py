"""Multi-device serving (port of ``repro/distributed``): the mesh and its
collectives (``context``) and the logical-axis sharding rules that slice
a full tree to one rank's shard (``sharding``)."""
