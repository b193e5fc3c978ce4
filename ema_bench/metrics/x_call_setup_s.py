"""Mean over the window's ``align -x`` calls of the set-up each call
repeats: the index load, the Aligner's construction with the index
text's upload (``aligner.init``) and the SMEM k-mer table's build
(``kmer_table``), from each call's own stage table."""

from ema_bench import program_spans as ps


def read(run):
    tables = ps.call_tables(run)
    if not tables or any("aligner.init" not in t for t in tables):
        return None
    return sum(t.get("index_load", 0.0) + t["aligner.init"]
               + t.get("kmer_table", 0.0) for t in tables) / len(tables)
