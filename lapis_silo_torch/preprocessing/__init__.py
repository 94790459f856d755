"""Ingest: metadata (TSV or NDJSON) and sequences (FASTA or NDJSON) become
a Database, which ``storage.snapshot.save_database`` writes as a snapshot
that the ``--api`` mode serves on the card.

The port's own copy of the JAX package's ingest. It is host work: no module
here touches a device. ``Preprocessor(pcfg, dbconf).preprocess()``
builds in one process (``preprocessor.py``), ``sharded.sharded_preprocess``
splits the sequence work over worker processes (NDJSON only), and the CLI
drives either:

    python -m lapis_silo_torch.cli --preprocessing \
        --preprocessingConfig preprocessing_config.yaml \
        --databaseConfig database_config.yaml [--ingestShards N]
"""
