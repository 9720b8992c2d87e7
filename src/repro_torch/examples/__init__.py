"""The port's counterparts of ``examples/*.py``, each run as
``python -m repro_torch.examples.<name>`` with the reference's flags plus
``--device`` (``cuda`` unless ``cpu`` is asked for):

  * ``train_bridge``: the image->event contrastive bridge (Eq. 1-3) trained
    with AdamW against frozen CLIP proxies;
  * ``quickstart``: the cache-gated window step switching between full,
    delta and bypass as a scene drifts, spikes in load and cuts;
  * ``serve_events``: a task's synthetic stream through the pipeline, AP@0.5
    and the cycle model's RT-60 latency.
"""
