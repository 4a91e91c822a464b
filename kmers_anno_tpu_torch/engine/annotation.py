"""The ``*.anno.tbl`` file names and header of the hash annotator
(Annotation.java).  A copy of what ``hashAnno`` uses from the reference
package's ``engine/annotation.py``: the directory scanner's file pattern
and the output header.
"""

from __future__ import annotations

import re

ANNO_FILE_RE = re.compile(r"(\d+\.\d+)\.anno\.tbl")
OUTPUT_HEADER = "fid\tscore\tnew_annotation\told_annotation"
