#!/bin/bash
# Build a minimal htslib-based BAM->SAM decoder (bam2sam) from the
# reference's vendored htslib, used ONLY as a test oracle to
# cross-validate mapcaller's own BGZF/BAM writer (io/bam.py)
# against a real htslib decode (VERDICT r3 missing #4; reference BAM
# call sites: /root/reference/src/ReadMapping.cpp:555,603,701).
# CRAM needs libbz2/liblzma (absent here) and is unused for BAM decode,
# so its objects are replaced with aborting stubs.
# Produces /tmp/htsbuild/bam2sam.
set -e
rm -rf /tmp/htsbuild
cp -r /root/reference/src/htslib /tmp/htsbuild
cd /tmp/htsbuild
make -j4 CFLAGS="-O2" \
  hts.o sam.o bgzf.o hfile.o hfile_net.o knetfile.o kstring.o md5.o \
  multipart.o textutils.o thread_pool.o hts_os.o > /dev/null

cat > bam2sam.c <<'EOF'
/* Minimal htslib-based BAM->SAM decoder: header text then one SAM
 * line per record, exactly what htslib parses out of the BAM bytes. */
#include <stdio.h>
#include "htslib/sam.h"
int main(int argc, char** argv) {
    if (argc != 2) { fprintf(stderr, "usage: bam2sam in.bam\n"); return 2; }
    samFile* in = sam_open(argv[1], "r");
    if (!in) { fprintf(stderr, "open failed\n"); return 1; }
    bam_hdr_t* h = sam_hdr_read(in);
    if (!h) { fprintf(stderr, "header read failed\n"); return 1; }
    fwrite(h->text, 1, h->l_text, stdout);
    bam1_t* b = bam_init1();
    kstring_t s = {0, 0, 0};
    while (sam_read1(in, h, b) >= 0) {
        s.l = 0;
        if (sam_format1(h, b, &s) < 0) { fprintf(stderr, "format failed\n"); return 1; }
        fputs(s.s, stdout); fputc('\n', stdout);
    }
    bam_destroy1(b);
    bam_hdr_destroy(h);
    sam_close(in);
    return 0;
}
EOF

cat > cram_stub.c <<'EOF'
/* CRAM/thread-pool symbols referenced by hts.o/bgzf.o but never
 * reached on the plain single-threaded BAM decode path. */
#include <stdlib.h>
#include <stdio.h>
#define STUB(n) int n() { fprintf(stderr, "cram stub hit: " #n "\n"); abort(); }
STUB(cram_check_EOF) STUB(cram_close) STUB(cram_dopen) STUB(cram_eof)
STUB(cram_get_bam_seq) STUB(cram_header_to_bam) STUB(cram_index_build)
STUB(cram_index_free) STUB(cram_index_load) STUB(cram_load_reference)
STUB(cram_put_bam_seq) STUB(cram_set_header) STUB(cram_set_option)
STUB(cram_set_voption) STUB(cram_write_SAM_hdr)
STUB(bam_header_to_cram) STUB(sam_hdr_name2ref)
STUB(pool_free) STUB(pool_destroy) STUB(pool_alloc) STUB(pool_create)
EOF

gcc -O2 -I. -c cram_stub.c
gcc -O2 -I. -c bam2sam.c
gcc -o bam2sam bam2sam.o cram_stub.o hts.o sam.o bgzf.o hfile.o \
    hfile_net.o knetfile.o kstring.o md5.o multipart.o textutils.o \
    thread_pool.o hts_os.o -lz -lm -lpthread
echo "built: /tmp/htsbuild/bam2sam"
