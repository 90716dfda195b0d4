"""Raw-data ingestion front of the evaluation harness (dataset loaders).

The reference harness loads raw corpora before embedding:
CVE JSON trees (reference tests/test_2_CVE_db.py:71-128), Quora duplicate
questions and BeIR/MS MARCO via HuggingFace `datasets`
(tests/test_1_quora_questions.py:31-75, tests/test_3_beir.py:24-82).
These are host-side copies of pyarrowspace_tpu/data/: numpy, with optional
third-party imports (the zero-egress default path is the checked-in
fixtures + models.hash_embed).
"""

from .cve import extract_cve_text, iter_cve_json, load_cve_corpus
from .hf import load_beir_msmarco, load_quora_duplicates

__all__ = ["iter_cve_json", "extract_cve_text", "load_cve_corpus",
           "load_quora_duplicates", "load_beir_msmarco"]
