"""The port's throughput tools, each the counterpart of the file of the same
name under the repository's ``tools/``; run as
``python -m feartracker_tpu_torch.tools.<name>``. They run on the card
unless ``BENCH_DEVICE`` names another device (``cpu`` in the tests), and
print the device's line before their JSON lines."""
