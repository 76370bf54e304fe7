"""pacbiokit4b's long-read tools of the port: the banded Smith-Waterman
engine (sswd.py), error correction (ecreads), SMRTbell hairpin filtering
(pbfilter), overlap assembly and contig polishing (pbassemb) and their
consensus (consensus.py)."""
