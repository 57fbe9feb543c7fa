"""File input: the FASTA/FASTQ reader and the streaming runner."""
