"""The plain references, in plain PyTorch: each works a traffic mix's outputs
out again from the lane's packed reads.  ``reference/<name>.py``, named by
a mix's ``reference``, defines ``reference(lane, cfg, device, control)``,
which returns ({check: [part]}, facts); ``pipeline.py`` and ``seqhash.py``
hold the steps they share.  Nothing here imports the program."""
