"""Metagenomic time-series (mts) binning suite.

Device-side counterpart of the reference's projects/mts tools
(kmer_multiplicity_counter.cpp, contig_abundance_counter.cpp,
prop_binning.cpp, stats.cpp) and the SeriesAnalysis stage
(projects/spades/series_analysis.cpp).
"""
