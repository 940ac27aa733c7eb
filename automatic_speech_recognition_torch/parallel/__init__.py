"""Data and tensor parallelism (counterpart of
automatic_speech_recognition_tpu/parallel/).

`distributed`: the process group torchrun describes, one process per GPU,
and its (data, model) grid.  `mesh`: the devices of a (data, model) mesh.
`sharding`: the JAX package's param_spec layout on the port's tensors,
whole checkpoints of a split state, and model replicas (split over
num_partitions devices each) with row splits for evaluation.
`tensor_parallel`: the column-parallel layers and the collectives GSPMD
inserts for JAX."""
