"""Utilities of the PyTorch port, the counterparts of videomamba_tpu/utils:

- ``basic_utils``: ``SmoothedValue``, ``MetricLogger`` (card memory in its
  progress line), ``compute_acc``, ``compute_n_params``, ``setup_seed``,
  file helpers;
- ``config``: ``.py`` / ``.yaml`` / ``.json`` configs with ``_base_``
  inheritance, ``Config``, ``merge_a_into_b``, ``eval_dict_leaf``;
- ``config_utils``: the DeepSpeed ZeRO JSON, ``zero_stage_to_mesh_plan``
  and ``setup_main``;
- ``distributed``: process-group init and collectives;
- ``easydict``: ``EasyDict``;
- ``logger``: per-rank logging, wandb and TensorBoard helpers;
- ``optimizer`` and ``scheduler``: AdamW with weight-decay groups, the
  cosine schedule with warmup;
- ``precision``: bf16 serving casts;
- ``profiling``: ``trace`` (``torch.profiler``), ``StepTimer``,
  ``device_memory_summary``, ``annotate`` (the port's ``vmt.`` spans,
  free without a profiler; the span names are in its docstring).
"""
