"""Framework primitives of the port — copies of the ``paddle_tpu.framework``
surface, not imports of it: typed errors, named locks, the stat
registry, and for the dygraph core the default place, the seeded
generators, dtype names and flags."""
