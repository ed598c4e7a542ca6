"""Multi-device paths (port of ``evflow/parallel``): ``mesh`` holds the
data-parallel mesh over ``torch.distributed`` ranks that ``evaluate``,
``train`` and their CLIs take. The reference's spatial, pipeline and tensor
parallel modules are not ported yet (ROADMAP.md queue 1 item 11)."""
