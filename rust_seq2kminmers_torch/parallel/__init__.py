"""The multi-process layer: the rank mesh, the data-parallel step, the
sequence-sharded step, the distributed file runner and a launcher."""
