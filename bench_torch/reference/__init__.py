"""Plain references of the configurations the benchmark runs, one module a
kind of model.

A configuration file's `reference` key names its module here
(`bench_torch/reference/<reference>.py`, loaded by `harness.reference`),
and that module is the one place for whatever depends on the model's
parameters.  The drivers, `weights.py`, `work.py` and `readers.py` take
these from the module they are handed, never from a module they import
by name, so a configuration of another kind comes in with new files: its
configuration, its reference module, the cell's entries and its readers.

A reference module provides:

- `param_spec(values) -> [(name, shape, init), ...]`: every tensor of
  the program's state dict for the configuration's values, in the order
  `weights.make` draws them.  init is ('glorot', fan_in, fan_out)
  uniform, ('uniform', limit), ('normal', std) or ('const', value).
- `model_flops(values, frames, steps) -> number`: the model's forward
  operations for one utterance past the frontend: the listener over
  `frames` real frames, the attention's encoder projection, and `steps`
  decoder steps.  `work.forward_flops` adds the frontend's count.
- `train_steps(w, values, batches, tf32=False) -> dict`: follow the
  program's first len(batches) training steps from the weights `w` on
  the same (audio, lens, labels) batches, in float32, or in TF32 for the
  control: 'loss' (each step's), 'first_grad' and 'raw_grad' (per leaf,
  the first step's clipped gradient as Adam holds it and its raw norm)
  and 'change' (per leaf, the norm of the change after the last step).

A module that a serving cell names provides besides
`forced_logits(w, values, audio, lens, tokens)` (teacher-forced inference
logits of served tokens) and `precision(tf32)` (a context manager).

Every configuration of the port shares the on-device frontend and the
tokenizer, so the frame arithmetic (`frame_params`, `num_frames`), the
frontend's filterbank and the special ids (`PAD`, `SOS`, `EOS`) stay in
`las.py`, and the traffic generator and the drivers import them from
there.
"""
