"""Data parallelism (counterpart of automatic_speech_recognition_tpu/parallel/).

`distributed`: the process group torchrun describes, one process per GPU.
`mesh`: the devices of a data axis.  `sharding`: model replicas and row
splits for evaluation over every local device."""
