"""The port's copies of the repo's verify-path report tools.

``verify_observatory`` joins the device ledger, the span files and the
cost model into a roofline verdict; ``critical_path`` and
``span_ledger`` are the span readers it stands on. Each runs as
``python -m simple_pbft_tpu_torch.tools.<name>`` and reads files only:
no kernel runs and no card is needed.
"""
